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
Tortoise's 16 candidates, prefills of 513 rows and Bark's 1024-frame fine
windows, and the conditioning encoders' ``K`` 80 and the perceiver's 2730
(no multiple of 16: the tiled kernel). Tolerances, as a share of the
output's peak: fp32 1e-5 (the kernel and the plain version sum in another
order); bf16 2^-7, one bf16 step at the peak (both round an fp32 sum once,
and sums that differ in their last bits may round to neighbours).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
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
]


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
