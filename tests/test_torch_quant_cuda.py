"""K4, the hand-written W8A16 kernel (``tts_tpu_torch/csrc/int8_linear.cu``),
against its plain version on a card.

Every test here needs a CUDA card (``cuda`` marker) and skips without one.
The file imports no JAX, so that it runs on the card's machine, where JAX is
not installed; the CPU tests that hold the plain version against the JAX
package are in ``tests/test_torch_quant.py``. Run on the card from the
repository root (the test settings import JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_quant_cuda.py -q

Shapes are the serving path's: XTTS v2 and Tortoise's 1024-wide layers
(``N`` 3072, 1024, 4096; ``K`` 4096 into ``mlp_proj``), the heads 1026 and
8194, Bark's 10,048 and 1056 without bias, ``M`` from a decode step's 1 to
Tortoise's 16 candidates, prefills of 513 and 887 rows and Bark's
1024-frame fine windows, and the conditioning encoders' ``K`` 80 and the
perceiver's 2730 (no multiple of 16: the tile kernel). The edges of each
kernel: ``M`` on either side of 16 and of the tile's 64 rows, ``N`` that
no tile divides, ``K`` 48, 80 and 2730, a weight that does not start on 16
bytes, strided rows, and each kernel forced by ``variant`` at the small
``M``. Tolerances, as a share of the output's peak: fp32 1e-5 (the kernel
and the plain version sum in another order); bf16 2^-7, one bf16 step at
the peak (both round an fp32 sum once, and sums that differ in their last
bits may round to neighbours).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import threading

import pytest
import torch

from tts_tpu_torch.ops import quant

TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
SHAPES = [  # (M, K, N, bias)
    (1, 1024, 3072, True), (1, 1024, 1024, True), (1, 1024, 4096, True), (1, 4096, 1024, True),
    (1, 1024, 1026, True), (2, 1024, 8194, True), (4, 1024, 3072, True), (4, 4096, 1024, True),
    (8, 1024, 1026, True), (16, 1024, 8194, True), (16, 4096, 1024, True),
    (1, 1024, 10048, False), (3, 1024, 1056, False), (513, 1024, 3072, False),
    (1024, 1024, 1056, True), (300, 80, 1024, True), (32, 2730, 1024, True), (5, 48, 40, True),
    # the edges: M about 16 and 64, N no tile divides, K 48 / 80 / 2730
    (2, 1024, 1026, True), (3, 1024, 8194, True), (5, 4096, 1024, True),
    (15, 1024, 10048, False), (17, 1024, 1056, False), (63, 1024, 3072, True),
    (65, 4096, 1024, True), (127, 1024, 40, True), (887, 1024, 3072, False),
    (887, 4096, 1024, False), (2, 48, 40, True), (5, 80, 1024, True), (15, 2730, 1024, True),
    (17, 2730, 1026, True), (65, 48, 1056, False), (3, 2730, 40, False),
]
VARIANT_SHAPES = [(1, 1024, 1026), (2, 4096, 1024), (3, 1024, 40), (5, 1024, 8194),
                  (8, 1024, 1056), (9, 64, 3072), (15, 1024, 1026), (16, 4096, 1024)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


def operands(M, K, N, bias, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(N, K, generator=gen, device=dev) / K ** 0.5
    q, scale = quant.quantize_int8(w)
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    b = torch.randn(N, generator=gen, device=dev).to(dtype) if bias else None
    return x, q, scale, b


def peak_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N,bias", SHAPES)
def test_kernel_matches_plain(card, M, K, N, bias, dtype):
    x, q, scale, b = operands(M, K, N, bias, dtype, card)
    launches = quant.int8_linear.launches
    got = quant.int8_linear(x, q, scale, b)
    again = quant.int8_linear(x, q, scale, b)
    torch.cuda.synchronize()
    assert quant.int8_linear.launches == launches + 2
    want = quant.int8_linear_torch(x, q, scale, b)
    assert got.shape == (M, N) and got.dtype == dtype
    assert peak_err(got, want) <= TOL[dtype]
    assert torch.equal(got, again)  # no atomics: the same bits every call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_strided_and_batched_rows(card, dtype):
    """A decode step's last position (``h[:, -1]``, rows ``T * K`` apart)
    and a ``[B, T, K]`` prefill give the rows of the contiguous call."""
    x, q, scale, b = operands(4 * 7, 1024, 1026, True, dtype, card, seed=1)
    x3 = x.reshape(4, 7, 1024)
    full = quant.int8_linear(x3, q, scale, b)
    last = quant.int8_linear(x3[:, -1], q, scale, b)
    torch.cuda.synchronize()
    assert full.shape == (4, 7, 1026)
    assert torch.equal(last, quant.int8_linear(x3[:, -1].contiguous(), q, scale, b))
    assert peak_err(full, quant.int8_linear_torch(x3, q, scale, b)) <= TOL[dtype]


@pytest.mark.cuda
def test_module_on_the_card_launches_the_kernel(card):
    """A quantized ``nn.Linear`` moved to the card runs K4 (one launch a
    call), its scales still fp32 after a move to bf16."""
    lin = torch.nn.Linear(1024, 3072)
    mod = quant.Int8Linear(lin).to(card, torch.bfloat16)
    assert mod.scale.dtype == torch.float32 and mod.weight_int8.device.type == "cuda"
    launches = quant.int8_linear.launches
    y = mod(torch.randn(2, 1024, device=card, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert quant.int8_linear.launches == launches + 1 and y.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["gemv", "skinny", "tile"])
@pytest.mark.parametrize("M,K,N", VARIANT_SHAPES)
def test_each_variant_matches_plain(card, M, K, N, variant, dtype):
    """Each of K4's kernels, forced, at the small M (where all three take
    the shape)."""
    x, q, scale, b = operands(M, K, N, True, dtype, card, seed=2)
    got = quant.int8_linear(x, q, scale, b, variant=variant)
    again = quant.int8_linear(x, q, scale, b, variant=variant)
    torch.cuda.synchronize()
    assert peak_err(got, quant.int8_linear_torch(x, q, scale, b)) <= TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M", [1, 4, 16, 65])
def test_unaligned_weight(card, M, dtype):
    """A weight one byte off 16 (a view into a larger buffer) takes the tile
    kernel at any M; the kernels that need 16-byte rows refuse it."""
    x, q, scale, b = operands(M, 1024, 1056, True, dtype, card, seed=3)
    buf = torch.zeros(q.numel() + 16, dtype=torch.int8, device=card)
    qu = buf[1:1 + q.numel()].view(q.shape)
    qu.copy_(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16 == 1
    got = quant.int8_linear(x, qu, scale, b)
    torch.cuda.synchronize()
    assert peak_err(got, quant.int8_linear_torch(x, q, scale, b)) <= TOL[dtype]
    assert torch.equal(got, quant.int8_linear(x, qu, scale, b))
    with pytest.raises(RuntimeError, match="int8_linear kernel launch"):
        quant.int8_linear(x, qu, scale, b, variant="skinny")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M", [2, 16, 40])
def test_every_other_row(card, M, dtype):
    """Rows ``2 K`` apart (``x[::2]``) in each kernel's range of M."""
    x, q, scale, b = operands(2 * M, 1024, 3072, True, dtype, card, seed=4)
    got = quant.int8_linear(x[::2], q, scale, b)
    torch.cuda.synchronize()
    assert torch.equal(got, quant.int8_linear(x[::2].contiguous(), q, scale, b))
    assert peak_err(got, quant.int8_linear_torch(x[::2], q, scale, b)) <= TOL[dtype]


@pytest.mark.cuda
def test_module_after_moves(card):
    """The module's launch is prepared at each move: fp32 on the card, then
    bf16, then off the card and back, each against the plain version on the
    same buffers, one launch a call."""
    mod = quant.Int8Linear(torch.nn.Linear(1024, 1026)).to(card)
    for dtype, move in ((torch.float32, None), (torch.bfloat16, lambda m: m.to(torch.bfloat16)),
                        (torch.bfloat16, lambda m: m.cpu().to(card))):
        if move is not None:
            move(mod)
        assert mod._k4 is not None and mod.scale.dtype == torch.float32
        assert mod.bias.dtype == dtype and mod.weight_int8.is_cuda
        for M in (1, 4, 16, 80):
            x = torch.randn(M, 1024, device=card).to(dtype)
            launches = quant.int8_linear.launches
            y = mod(x)
            torch.cuda.synchronize()
            assert quant.int8_linear.launches == launches + 1 and y.dtype == dtype
            want = quant.int8_linear_torch(x, mod.weight_int8, mod.scale, mod.bias)
            assert peak_err(y, want) <= TOL[dtype]


@pytest.mark.cuda
def test_two_threads_launch_at_once(card):
    """Two threads call one module on streams of their own: each gets its
    rows, and every launch is counted."""
    mod = quant.Int8Linear(torch.nn.Linear(1024, 3072)).to(card, torch.bfloat16)
    xs = [torch.randn(4, 1024, device=card, dtype=torch.bfloat16) for _ in range(2)]
    want = [mod(x) for x in xs]
    torch.cuda.synchronize()  # the side streams read xs
    got = [[], []]
    launches = quant.int8_linear.launches

    def serve(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(200):
                got[i].append(mod(xs[i]))
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert quant.int8_linear.launches == launches + 400
    for i in range(2):
        assert all(torch.equal(y, want[i]) for y in got[i])
