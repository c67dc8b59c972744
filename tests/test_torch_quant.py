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
import copy
import re
import threading

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
    the plain version, by the public function and by the module; the
    wrapper's descriptor has the C entry point's fields in its order."""
    q = torch.zeros(8, 16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int8_linear(torch.zeros(2, 16, device="meta"), q, torch.ones(8, device="meta"))
    mod = quant.Int8Linear(nn.Linear(16, 8)).to("meta")
    assert mod._k4 is None  # a launch is prepared on a card only
    with pytest.raises(ValueError, match="unsupported device"):
        mod(torch.zeros(2, 16, device="meta"))
    struct = re.search(r"struct Desc \{(.*?)\};", (CSRC_DIR / "int8_linear.cu").read_text(), re.S)
    fields = re.findall(r"(\w+);", re.sub(r"//[^\n]*", "", struct.group(1)))
    assert fields == [name for name, _ in quant._Desc._fields_]


def _bad_module(what: str):
    """An ``Int8Linear`` 32 -> 8 (or the ``nn.Linear`` it is built from)
    with one buffer or the bias made unfit for the int8 path."""
    lin = nn.Linear(32, 8)
    if what == "bias_shape":
        lin.bias = nn.Parameter(torch.zeros(9))
        return lin
    if what == "bias_int":
        lin.bias = nn.Parameter(torch.zeros(8, dtype=torch.int64), requires_grad=False)
        return lin
    mod = quant.Int8Linear(lin)
    if what == "scale_shape":
        mod.scale = torch.ones(9)
    elif what == "scale_dtype":
        mod.scale = torch.ones(8, dtype=torch.float16)
    elif what == "weight_dtype":
        mod.weight_int8 = torch.zeros(8, 32, dtype=torch.int16)
    elif what == "weight_layout":
        mod.weight_int8 = torch.zeros(32, 8, dtype=torch.int8).t()
    elif what == "weight_shape":
        mod.weight_int8 = torch.zeros(8, 16, dtype=torch.int8)
    elif what == "moved_bias_shape":
        mod.bias = nn.Parameter(torch.zeros(7), requires_grad=False)
    return mod


@pytest.mark.parametrize("what", ["bias_shape", "bias_int"])
def test_int8_linear_refuses_bad_bias_when_built(what):
    with pytest.raises((TypeError, ValueError), match="Int8Linear"):
        quant.Int8Linear(_bad_module(what))


@pytest.mark.parametrize("what", ["scale_shape", "scale_dtype", "weight_dtype", "weight_layout",
                                  "weight_shape", "moved_bias_shape"])
def test_int8_linear_refuses_bad_buffers_when_moved(what):
    """A buffer or bias assigned after the build is checked at the next move
    (``_apply``: ``.to``, ``.cuda``, ``.bfloat16``), where the launch would
    be prepared."""
    mod = _bad_module(what)
    with pytest.raises((TypeError, ValueError), match="Int8Linear"):
        mod.to(torch.float32)


def test_int8_linear_checked_once_and_moved_twice():
    """A good module passes its checks at the build and at each move, keeps
    no prepared launch off a card, and computes the plain version's values
    in the moved type."""
    lin = nn.Linear(64, 48)
    mod = quant.Int8Linear(lin)
    x = torch.randn(3, 64)
    want = quant.int8_linear_torch(x, mod.weight_int8, mod.scale, mod.bias)
    mod.to(torch.bfloat16).to(torch.float32)
    assert mod._k4 is None and mod.scale.dtype == torch.float32
    assert mod.bias.dtype == torch.float32
    np.testing.assert_allclose(mod(x).numpy(), want.numpy(), rtol=0,
                               atol=2 ** -7 * want.abs().max().item())


CHECK_CASES = {  # what is wrong -> (error, message)
    "x_width": (ValueError, "against weight"),
    "x_dtype": (TypeError, "fp32 or bf16"),
    "q_dtype": (TypeError, "int8 weight"),
    "q_layout": (TypeError, "int8 weight"),
    "scale_dtype": (TypeError, "fp32 scale"),
    "scale_shape": (TypeError, "fp32 scale"),
    "bias_shape": (ValueError, "bias"),
    "q_device": (ValueError, "weight on cpu"),
    "variant": (ValueError, "variant"),
    "nothing": (ValueError, "unsupported device"),
}


@pytest.mark.parametrize("what", sorted(CHECK_CASES))
def test_public_int8_linear_checks_bare_tensors(what):
    """``int8_linear`` with bare tensors off the CPU checks them all on every
    call, before it would launch (``meta`` tensors: every check runs, and
    the device is refused last)."""
    meta = dict(device="meta")
    x = torch.zeros(4, 16, **meta)
    q = torch.zeros(8, 16, dtype=torch.int8, **meta)
    scale, bias, kw = torch.ones(8, **meta), torch.zeros(8, **meta), {}
    if what == "x_width":
        x = torch.zeros(4, 12, **meta)
    elif what == "x_dtype":
        x = x.half()
    elif what == "q_dtype":
        q = q.to(torch.int16)
    elif what == "q_layout":
        q = torch.zeros(16, 8, dtype=torch.int8, **meta).t()
    elif what == "scale_dtype":
        scale = scale.double()
    elif what == "scale_shape":
        scale = torch.ones(9, **meta)
    elif what == "bias_shape":
        bias = torch.zeros(7, **meta)
    elif what == "q_device":
        q = torch.zeros(8, 16, dtype=torch.int8)
    elif what == "variant":
        kw = {"variant": "fastest"}
    error, message = CHECK_CASES[what]
    with pytest.raises(error, match=message):
        quant.int8_linear(x, q, scale, bias, **kw)


def split_values(kind: str) -> torch.Tensor:
    rs = np.random.RandomState(7)
    if kind == "random":
        v = rs.randn(4096) * np.exp(rs.uniform(-8, 8, 4096))
    elif kind == "huge":
        v = rs.uniform(1.0, 9.9, 4096) * 10.0 ** rs.randint(30, 38, 4096)
    elif kind == "tiny":  # down to 2^-100: the lowest part stays normal in bf16
        v = rs.uniform(1.0, 2.0, 4096) * 2.0 ** rs.randint(-100, -80, 4096)
    else:  # signed, all mantissa bits set, powers of two, zeros, halfway cases
        bits = rs.randint(0, 2 ** 23, 4096).astype(np.uint32) | (127 << 23)
        v = bits.view(np.float32).astype(np.float64)
        v[:8] = [1.0, -1.0, 0.0, -0.0, 2.0 ** 20, -(2.0 ** -20), 1 + 2 ** -8, -(1 + 2 ** -9)]
        v[8:16] = np.float32(np.nextafter(np.float32(1.0), np.float32(2.0)))
    sign = np.where(rs.rand(4096) < 0.5, -1.0, 1.0)
    return torch.from_numpy((v * sign).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "huge", "tiny", "signed"])
def test_bf16_split3_is_exact(kind):
    """K4's fp32 path splits activations into three bf16 parts that sum to
    them bit for bit: in float64, and in fp32 as the kernel adds them."""
    x = split_values(kind)
    hi, mid, lo = quant.bf16_split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal(hi.float() + (mid.float() + lo.float()), x)
    # each part's product with any int8 value is exact in fp32 (where it
    # stays below the fp32 maximum)
    w = torch.arange(-127, 128, dtype=torch.float64)
    for part in (hi, mid, lo):
        prod = part.double()[:64, None] * w
        finite = prod.abs() < torch.finfo(torch.float32).max
        assert torch.equal(prod.float().double()[finite], prod[finite])


@pytest.mark.parametrize("M,K,N,bias", [(5, 96, 40, True), (33, 80, 130, False),
                                        (16, 1024, 64, True)])
def test_split_product_matches_plain(M, K, N, bias):
    """The three-part product (K4's fp32 arithmetic) against the plain
    version within 1e-6 of the output's peak, on activations over 16
    octaves."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy((rs.randn(M, K) * np.exp(rs.uniform(-4, 4, (M, K)))).astype(np.float32))
    q = torch.from_numpy(rs.randint(-127, 128, (N, K)).astype(np.int8))
    scale = torch.from_numpy(rs.rand(N).astype(np.float32) * 0.01)
    b = torch.from_numpy(rs.randn(N).astype(np.float32)) if bias else None
    got = quant.int8_linear_split_torch(x, q, scale, b)
    want = quant.int8_linear_torch(x, q, scale, b)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=REL * want.abs().max().item())


def test_launch_count_is_kept_per_thread():
    """Concurrent launches count in entries of their own threads: none is
    lost, the count reads as their sum and resets to 0 only."""
    quant.int8_linear.launches = 0
    try:
        def work():
            for _ in range(2000):
                quant.int8_linear.count()

        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert quant.int8_linear.launches == 8000
        with pytest.raises(ValueError, match="reset to 0"):
            quant.int8_linear.launches = 3
    finally:
        quant.int8_linear.launches = 0
    assert quant.int8_linear.launches == 0


def test_quantized_module_copies():
    """A deep copy carries the buffers and no prepared launch (its raw
    pointers would point into the original's tensors)."""
    mod = quant.Int8Linear(nn.Linear(64, 32))
    twin = copy.deepcopy(mod)
    assert twin._k4 is None and twin.weight_int8.data_ptr() != mod.weight_int8.data_ptr()
    x = torch.randn(2, 64)
    assert torch.equal(twin(x), mod(x))
