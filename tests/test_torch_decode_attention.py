"""tts_tpu_torch decode attention (port of the Pallas kernel K1,
``tts_tpu/ops/pallas_attention.py::decode_attention``).

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode and against the XLA reference on
the same numpy inputs, fp32 atol 1e-5 (float32 sums in another order). So is
the plain version of the kernel's split-and-merge arithmetic
(``decode_attention_split_torch``), with the split plan the kernel uses and
with forced splits that hold no valid key. The CUDA kernel itself runs only
on a card (``cuda`` marker; ``chip_smoke.py`` covers the same cases at XTTS
v2 shapes).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_tpu.ops.pallas_attention import decode_attention as pallas_decode_attention
from tts_tpu.ops.pallas_attention import decode_attention_xla
from tts_tpu_torch.ops import cuda_build
from tts_tpu_torch.ops.decode_attention import (
    _check_cuda_args,
    _Workspace,
    decode_attention,
    decode_attention_split_torch,
    decode_attention_torch,
    split_plan,
)


def _inputs(B, S, H, dh, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, dh).astype(np.float32)
    k = rng.randn(B, S, H, dh).astype(np.float32)
    v = rng.randn(B, S, H, dh).astype(np.float32)
    return q, k, v


# (B, S, lens): full cache, a single valid slot, per-row lengths, a scalar
# broadcast over rows, a 0-d length, and S that is no multiple of any block
CASES = [
    (2, 128, [128, 128]),
    (2, 128, [1, 1]),
    (3, 96, [1, 37, 96]),
    (2, 64, 40),
    (1, 685, np.int32(685)),
    (4, 37, [5, 37, 1, 20]),
]


@pytest.mark.parametrize("B,S,lens", CASES)
def test_plain_matches_pallas_and_xla(B, S, lens):
    H, dh = 4, 64
    q, k, v = _inputs(B, S, H, dh)
    lens_np = np.asarray(lens, np.int32)
    want_pallas = np.asarray(
        pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens_np), interpret=True)
    )
    want_xla = np.asarray(
        decode_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np))
    )
    cache_len = lens if isinstance(lens, int) else torch.from_numpy(lens_np)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cache_len)
    assert got.dtype == torch.float32 and got.shape == (B, H, dh)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5)


def test_bf16_cache_is_computed_in_fp32():
    """bf16 caches: the plain version upcasts the bf16 values and computes in
    fp32, so it equals the fp32 computation on the rounded values."""
    q, k, v = _inputs(2, 50, 4, 64, seed=3)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = decode_attention(qb, kb, vb, torch.tensor([50, 9]))
    want = decode_attention_xla(*(jnp.asarray(t.float().numpy()) for t in (qb, kb, vb)),
                                jnp.asarray([50, 9]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_positions_past_length_are_ignored():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 64, seed=1))
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 1e3
    v2[:, 10:] = 1e3
    a = decode_attention(q, k, v, 10)
    b = decode_attention(q, k2, v2, 10)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_strided_query_matches_contiguous():
    """The decode query is a view into the fused QKV projection; the kernel
    takes its strides, and the plain version must agree either way."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 40, 4, 64, seed=2))
    qkv = torch.cat([q.reshape(3, 256), torch.zeros(3, 512)], dim=1)
    q_view = qkv[:, :256].reshape(3, 4, 64)
    assert not q_view.is_contiguous()
    np.testing.assert_array_equal(
        decode_attention(q_view, k, v, 40).numpy(), decode_attention(q, k, v, 40).numpy()
    )


@pytest.mark.parametrize(
    "dtype,dh,k_layout,err",
    [
        (torch.float16, 64, "contiguous", TypeError),  # kernel takes fp32 / bf16
        (torch.float32, 48, "contiguous", ValueError),  # dh/4 lanes not a power of two
        (torch.bfloat16, 64, "head_minor", ValueError),  # last dim not contiguous
    ],
)
def test_kernel_argument_checks_raise(dtype, dh, k_layout, err):
    """The CUDA wrapper refuses what the kernel cannot take (checked on CPU
    tensors: the checks are plain Python, run before any launch)."""
    q = torch.zeros(2, 4, dh, dtype=dtype)
    k = torch.zeros(2, 16, 4, dh, dtype=dtype)
    if k_layout == "head_minor":
        k = torch.zeros(2, 16, dh, 4, dtype=dtype).transpose(2, 3)
    with pytest.raises(err):
        _check_cuda_args(q, k, k)


def test_other_devices_raise():
    q = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, q[:, None], q[:, None], 1)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's output; nothing falls back."""
    (tmp_path / "probe.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.load_library("probe")
    assert "probe" not in cuda_build._loaded


@pytest.mark.parametrize(
    "B,H,S,n",
    [(1, 16, 685, 685), (4, 16, 685, 685), (1, 16, 720, 33), (1, 16, 720, 95),
     (1, 16, 720, 300), (4, 16, 1024, None), (1, 16, 720, 0), (1, 16, 720, -3),
     (3, 4, 96, 1), (2, 4, 5000, 4999), (1, 1, 7, None)],
)
def test_split_plan_covers_the_valid_keys(B, H, S, n):
    splits, chunk = split_plan(B, H, S, n)
    keys = S if n is None or n <= 0 else min(n, S)
    spans = [(s * chunk, min((s + 1) * chunk, keys)) for s in range(splits)]
    # the splits cover exactly [0, keys), in order, none empty, none overlapping
    assert spans[0][0] == 0 and spans[-1][1] == keys
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(splits - 1))
    if (B, H, n) == (1, 16, 685):
        # fills an H100 at B=1 with one block per SM: 16 heads x 8 splits on
        # 128 of its 132 SMs (9 splits would put two blocks on 12 SMs)
        assert 128 <= splits * B * H <= 132
    assert splits * B * H <= 132 or splits == 1


@pytest.mark.parametrize("sm_count,splits", [(132, 8), (114, 7), (78, 4), (16, 1)])
def test_split_plan_follows_the_sm_count(sm_count, splits):
    """At B=1, H=16, n=685 the grid takes at most one block per SM of the
    card it runs on (132 on an H100 SXM, 114 on an H100 PCIe)."""
    assert split_plan(1, 16, 685, 685, sm_count) == (splits, -(-685 // splits))
    assert split_plan(1, 16, 685, None, sm_count)[0] * 16 <= max(sm_count, 16)


# (B, S, lens, splits): per-row lengths sized from S, where every row shorter
# than S leaves splits with no valid key; all-masked rows (length 0 or less)
CASES_EMPTY_SPLITS = [
    (3, 96, [1, 37, 96], 8),
    (2, 700, [3, 700], 40),  # 40 splits: three batches of the kernel's merge
    (1, 685, 685, 20),
    (4, 37, [5, 37, 1, 20], 37),
    (2, 128, [0, 64], 4),
    (2, 64, [-1, 3], 16),
    (2, 64, 0, 3),
]


@pytest.mark.parametrize(
    "B,S,lens,splits",
    [(B, S, lens, None) for B, S, lens in CASES] + CASES_EMPTY_SPLITS,
)
def test_split_plain_matches_pallas_and_xla(B, S, lens, splits):
    H, dh = 4, 64
    q, k, v = _inputs(B, S, H, dh, seed=5)
    lens_np = np.asarray(lens, np.int32)
    if lens_np.ndim == 0:
        lens_np = np.full((B,), lens_np, np.int32)
    want_pallas = np.asarray(
        pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens_np), interpret=True)
    )
    want_xla = np.asarray(
        decode_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np))
    )
    cache_len = lens if isinstance(lens, int) else torch.from_numpy(np.asarray(lens, np.int32))
    got = decode_attention_split_torch(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), cache_len, splits)
    assert got.dtype == torch.float32 and got.shape == (B, H, dh)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5)


def test_workspace_grows_and_keeps_zeroed_counters():
    ws = _Workspace()
    ml, acc, counters = ws.pointers("cpu", 16 * 17, 64, 16)
    assert acc - ml == 4 * 2 * 16 * 17 and ws.partials.numel() == 16 * 17 * 66
    first = ws.partials
    ws.pointers("cpu", 4, 64, 16)  # smaller: reused as it is
    assert ws.partials is first
    ws.pointers("cpu", 64 * 5, 64, 64)  # larger: grown, counters zeroed
    assert ws.partials.numel() == 64 * 5 * 66 and ws.counters.numel() == 64
    assert ws.counters.dtype == torch.int32 and not ws.counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_cuda_kernel_matches_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S in ((1, 685), (1, 720), (4, 1024)):
        q = torch.randn(B, 16, 64, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, 16, 64, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, 16, 64, generator=gen, device=dev).to(dtype)
        lens = torch.tensor([(1, 37, S)[b % 3] for b in range(B)], dtype=torch.int32, device=dev)
        before = decode_attention.launches
        lengths = (lens, S - 3, 33, 95, 300, 0)
        for cache_len in lengths:
            got = decode_attention(q, k, v, cache_len)
            want = decode_attention_torch(q.float(), k.float(), v.float(), cache_len)
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= tol
            assert torch.equal(got, decode_attention(q, k, v, cache_len))  # deterministic
        assert decode_attention.launches == before + 2 * len(lengths)
