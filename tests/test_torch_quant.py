"""tts_tpu_torch weight-only int8 (``tts_tpu_torch.ops.quant``) against the
JAX package's ``tts_tpu.ops.quant`` on the CPU.

``quantize_int8`` must give the JAX function's int8 values and scales bit
for bit on the same weights, in torch's layout (a flax ``[in, out]`` Dense
kernel is a ``[out, in]`` weight, a ``[k, in, out]`` Conv kernel a ``[out,
in, k]`` one): 2-D and 3-D weights, the 4096-element threshold, an all-zero
channel (the 1e-12 floor) and values exactly halfway between two steps
(round half to even). The modules' plain paths (K4's plain version, the
dequantized convolution) agree with the JAX ``dequantize`` followed by the
dot or the convolution within 1e-6 of the output's peak (fp32: the scale is
applied after the sum here, before it there). K4 itself runs only on a card
(``tests/test_torch_quant_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import re

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from tts_tpu.ops import quant as jax_quant
from tts_tpu_torch.ops import quant
from tts_tpu_torch.ops.cuda_build import CSRC_DIR
from tts_tpu_torch.utils.convert import flax_to_state_dict

REL = 1e-6


def torch_layout(kernel: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's weight layout: Dense ``[in, out]`` →
    ``[out, in]``, Conv ``[k, in, out]`` → ``[out, in, k]``."""
    return kernel.T if kernel.ndim == 2 else kernel.transpose(2, 1, 0)


def jax_quantized(kernel: np.ndarray, min_elems: int = quant.MIN_ELEMS):
    return jax_quant.quantize_int8({"d": {"kernel": jnp.asarray(kernel)}},
                                   min_elems=min_elems)["d"]["kernel"]


def ties() -> np.ndarray:
    """A ``[in 8, out 3]`` kernel whose channels' maxima are 127, so every
    scale is 1.0 and the other values sit exactly halfway between steps."""
    k = np.array([[127, -127, 127], [2.5, 3.5, -0.5], [-2.5, -3.5, 0.5], [1.5, 126.5, -126.5],
                  [-1.5, 0.5, 4.5], [10.5, -10.5, 11.5], [0.0, 100.5, -99.5], [5.5, 6.5, 7.5]],
                 np.float32)
    return k


def kernels():
    rs = np.random.RandomState(0)
    zero = rs.randn(64, 96).astype(np.float32)
    zero[:, 17] = 0.0  # an all-zero output channel: the scale's 1e-12 floor
    return {
        "dense": rs.randn(64, 128).astype(np.float32) * rs.rand(128).astype(np.float32),
        "conv_k1": rs.randn(1, 64, 192).astype(np.float32),
        "conv_k3": (rs.randn(3, 32, 48) * 0.05).astype(np.float32),
        "zero_channel": zero,
        "threshold_4096": rs.randn(64, 64).astype(np.float32),
        "ties": ties(),
    }


@pytest.mark.parametrize("name", sorted(kernels()))
def test_quantize_int8_bit_identical_to_jax(name):
    kernel = kernels()[name]
    want = jax_quantized(kernel, min_elems=1)
    q, scale = quant.quantize_int8(torch.from_numpy(torch_layout(kernel).copy()))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), torch_layout(np.asarray(want["int8"])))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]).reshape(-1))
    if name == "zero_channel":
        assert scale[17].item() == np.float32(1e-12) and not q[17].any()
    if name == "ties":  # round half to even, as jnp.round
        assert q[1].tolist() == [-127, 4, -4, 126, 0, -10, 100, 6]


def test_threshold_and_eligible_modules_match_jax():
    """4095 elements stay float, 4096 are quantized, in both packages; so do
    a 3-D convolution kernel, and nothing but Linear and Conv1d weights."""
    rs = np.random.RandomState(1)
    flax = {"small": {"kernel": rs.randn(63, 65).astype(np.float32),
                      "bias": np.zeros(65, np.float32)},
            "exact": {"kernel": rs.randn(64, 64).astype(np.float32),
                      "bias": np.zeros(64, np.float32)},
            "conv": {"kernel": rs.randn(3, 40, 40).astype(np.float32),
                     "bias": np.zeros(40, np.float32)},
            "norm": {"scale": np.ones(4096, np.float32), "bias": np.zeros(4096, np.float32)},
            "table": {"embedding": rs.randn(128, 64).astype(np.float32)}}
    jq = jax_quant.quantize_int8(flax)
    jax_set = {k for k, v in jq.items() if isinstance(v.get("kernel"), dict)}
    root = nn.ModuleDict({"small": nn.Linear(63, 65), "exact": nn.Linear(64, 64),
                          "conv": nn.Conv1d(40, 40, 3, padding=1),
                          "norm": nn.LayerNorm(4096), "table": nn.Embedding(128, 64)})
    root.load_state_dict(flax_to_state_dict(flax))
    assert sorted(quant.quantize_modules(root)) == sorted(jax_set) == ["conv", "exact"]
    assert isinstance(root["exact"], quant.Int8Linear)
    assert isinstance(root["conv"], quant.Int8Conv1d)
    assert type(root["small"]) is nn.Linear and quant.is_quantized(root)


def test_carried_quantized_tree_equals_the_ports_quantization():
    """A quantized JAX tree carried by ``flax_to_state_dict`` gives the int8
    modules' buffers, transposed, bit for bit: the same tensors as the
    port's own quantization of the carried float weights."""
    rs = np.random.RandomState(2)
    flax = {"dense": {"kernel": rs.randn(64, 96).astype(np.float32),
                      "bias": rs.randn(96).astype(np.float32)},
            "conv": {"kernel": rs.randn(1, 64, 128).astype(np.float32),
                     "bias": rs.randn(128).astype(np.float32)}}
    carried = flax_to_state_dict(jax_quant.quantize_int8(flax))
    root = nn.ModuleDict({"dense": nn.Linear(64, 96), "conv": nn.Conv1d(64, 128, 1)})
    root.load_state_dict(flax_to_state_dict(flax))
    quant.quantize_modules(root)
    own = root.state_dict()
    assert set(carried) == set(own) == {
        "dense.weight_int8", "dense.scale", "dense.bias",
        "conv.weight_int8", "conv.scale", "conv.bias"}
    for key in own:
        assert carried[key].dtype == own[key].dtype and torch.equal(carried[key], own[key]), key
    fresh = nn.ModuleDict({"dense": nn.Linear(64, 96), "conv": nn.Conv1d(64, 128, 1)})
    quant.quantize_modules(fresh)
    fresh.load_state_dict(carried)  # the carried state loads into a quantized module strictly


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_plain_matches_jax_dequantize_and_dot(bias):
    rs = np.random.RandomState(3)
    kernel = (rs.randn(96, 160) / np.sqrt(96)).astype(np.float32)
    b = rs.randn(160).astype(np.float32)
    x = rs.randn(5, 7, 96).astype(np.float32)
    dq = jax_quant.dequantize(jax_quantized(kernel), jnp.float32)
    want = np.asarray(jnp.asarray(x) @ dq + (b if bias else 0.0))
    lin = nn.Linear(96, 160, bias=bias)
    lin.weight.data = torch.from_numpy(kernel.T.copy())
    if bias:
        lin.bias.data = torch.from_numpy(b)
    mod = quant.Int8Linear(lin)
    got = mod(torch.from_numpy(x))
    assert got.shape == (5, 7, 160) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * np.abs(want).max())
    # a strided row view (a decode step's last position) gives the same rows
    np.testing.assert_array_equal(mod(torch.from_numpy(x)[:, -1]).numpy(), got[:, -1].numpy())


def test_bf16_activations_sum_in_fp32():
    """bf16 in, bf16 out: the plain version widens the bf16 values, sums in
    fp32 and rounds once."""
    rs = np.random.RandomState(4)
    q = torch.from_numpy(rs.randint(-127, 128, (48, 64)).astype(np.int8))
    scale = torch.from_numpy(rs.rand(48).astype(np.float32) * 0.01)
    x = torch.from_numpy(rs.randn(3, 64).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rs.randn(48).astype(np.float32)).bfloat16()
    got = quant.int8_linear(x, q, scale, bias)
    want = ((x.double() @ q.double().T) * scale.double() + bias.double()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of a value whose fp32 sum may differ in its last bits
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2 ** -7, atol=0)


def test_int8_conv1d_matches_jax_dequantized_conv():
    """A quantized k=3 convolution against flax's ``nn.Conv`` on the JAX
    ``dequantize`` of the same tree."""
    rs = np.random.RandomState(5)
    kernel = (rs.randn(3, 32, 48) / np.sqrt(96)).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    x = rs.randn(2, 20, 32).astype(np.float32)  # flax: [B, T, C]
    tree = jax_quant.quantize_int8({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(b)})
    conv = fnn.Conv(48, (3,), padding=1)
    want = np.asarray(conv.apply({"params": jax_quant.dequantize(tree, jnp.float32)},
                                 jnp.asarray(x)))
    root = nn.ModuleDict({"c": nn.Conv1d(32, 48, 3, padding=1)})
    root.load_state_dict(flax_to_state_dict({"c": {"kernel": kernel, "bias": b}}))
    mod = quant.Int8Conv1d(root["c"])
    got = mod(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_swap_frees_float_weights_and_keeps_scales_fp32():
    """The swapped module holds no float weight; moving it to bf16 casts the
    bias, keeps the int8 weight and the fp32 scales bit for bit."""
    root = nn.Sequential(nn.Linear(128, 256), nn.GELU(), nn.Linear(256, 128))
    before = quant.quantized_bytes(root)
    names = quant.quantize_modules(root)
    assert names == ["0", "2"] and not hasattr(root[0], "weight")
    assert not any(p.dim() > 1 for p in root.parameters())
    assert quant.quantized_bytes(root) < before / 3
    scale = root[0].scale.clone()
    root.to(torch.bfloat16)
    assert root[0].bias.dtype == torch.bfloat16 and root[0].weight_int8.dtype == torch.int8
    assert root[0].scale.dtype == torch.float32 and torch.equal(root[0].scale, scale)
    y = root(torch.randn(2, 128).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (2, 128)
    np.testing.assert_array_equal(
        quant.maybe_dequantize(root[2]).numpy(),
        root[2].weight_int8.float().numpy() * root[2].scale.numpy()[:, None])


def test_cuda_path_never_falls_back():
    """A tensor on neither the CPU nor a card is refused, not computed by
    the plain version; the wrapper packs as many arguments as the C entry
    point reads."""
    q = torch.zeros(8, 16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int8_linear(torch.zeros(2, 16, device="meta"), q, torch.ones(8, device="meta"))
    enum = re.search(r"enum Arg \{(.*?)\};", (CSRC_DIR / "int8_linear.cu").read_text(), re.S)
    names = [n.strip() for n in enum.group(1).split(",") if n.strip()]
    assert names[-1] == "kNumArgs" and len(names) - 1 == quant._NUM_ARGS
