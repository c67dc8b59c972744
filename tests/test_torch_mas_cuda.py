"""K2, the hand-written MAS kernel (``tts_tpu_torch/csrc/mas.cu``), against
its plain version on a card.

Every test here needs a CUDA card (``cuda`` marker) and skips without one.
The file imports no JAX, so that it runs on the card's machine, where JAX is
not installed; ``tests/test_torch_mas.py`` holds the plain version against
the JAX package on the CPU. Run on the card from the repository root (the
test settings import JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mas_cuda.py -q

The paths must be identical to the plain version's (the kernel repeats its
fp32 operations in its order) and two calls bit-identical. Inputs: random,
tied (integer-valued) and ragged scores, more tokens than frames, an item
with an empty mask, bf16 values, boolean and bf16 masks, strided views, the
VITS recipe's B=32 × 381 tokens × 861 frames, and the direction bits kept
in the global scratch buffer instead of shared memory.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest
import torch

from tts_tpu_torch.ops import mas


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ragged(B, T_x, T_y, dev, tied=False, seed=0, empty=()):
    gen = torch.Generator().manual_seed(seed)
    value = torch.randn(B, T_x, T_y, generator=gen) * 3
    if tied:
        value = torch.round(value)
    x_len = torch.randint(1, T_x + 1, (B,), generator=gen)
    y_len = torch.randint(1, T_y + 1, (B,), generator=gen)
    x_len[0], y_len[0] = T_x, T_y
    for b in empty:
        x_len[b] = 0
    mask = ((torch.arange(T_x)[None, :, None] < x_len[:, None, None])
            & (torch.arange(T_y)[None, None, :] < y_len[:, None, None])).float()
    return value.to(dev), mask.to(dev)


def check(value, mask, **kw):
    launches = mas.maximum_path.launches
    got = mas.maximum_path(value, mask, **kw)
    again = mas.maximum_path(value, mask, **kw)
    torch.cuda.synchronize()
    assert mas.maximum_path.launches == launches + 2
    want = mas.maximum_path_torch(value, mask)
    assert got.dtype == value.dtype and got.shape == value.shape
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    return got


SHAPES = [  # (B, T_x, T_y, tied)
    (4, 13, 40, False), (4, 13, 40, True), (3, 20, 9, False), (3, 1, 17, False),
    (3, 6, 1, True), (2, 33, 64, True), (5, 100, 300, False), (2, 1030, 40, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y,tied", SHAPES)
def test_kernel_equals_plain(card, B, T_x, T_y, tied):
    check(*ragged(B, T_x, T_y, card, tied=tied, seed=T_x))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y,tied", SHAPES[:6])
def test_scratch_bits_equal_shared_bits(card, B, T_x, T_y, tied):
    """The second storage path of the direction bits (a global buffer)."""
    value, mask = ragged(B, T_x, T_y, card, tied=tied, seed=T_y)
    assert torch.equal(check(value, mask, shared_bits=False), mas.maximum_path(value, mask))


@pytest.mark.cuda
def test_empty_item(card):
    value, mask = ragged(3, 8, 20, card, seed=3, empty=(1,))
    got = check(value, mask)
    assert not got[1].any() and got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16, torch.bool],
                         ids=["fp32", "bf16", "bool"])
def test_types(card, vdtype, mdtype):
    value, mask = ragged(4, 37, 90, card, seed=11)
    check(value.to(vdtype), mask.to(mdtype))


@pytest.mark.cuda
def test_strided_views(card):
    value, mask = ragged(3, 25, 70, card, seed=13)
    vt = value.transpose(1, 2).contiguous().transpose(1, 2)
    mt = mask.transpose(1, 2).contiguous().transpose(1, 2)
    assert not vt.is_contiguous()
    assert torch.equal(check(vt, mt), mas.maximum_path(value, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("shared_bits", [None, False], ids=["shared", "scratch"])
def test_recipe_shapes(card, shared_bits):
    """B=32, text 61-381 ids, 861 frames at most, as a VITS step runs it."""
    gen = torch.Generator().manual_seed(0)
    x_len = torch.randint(61, 382, (32,), generator=gen)
    y_len = torch.randint(172, 862, (32,), generator=gen)
    x_len[0], y_len[0] = 381, 861
    value = -torch.rand(32, 381, 861, generator=gen) * 100
    mask = ((torch.arange(381)[None, :, None] < x_len[:, None, None])
            & (torch.arange(861)[None, None, :] < y_len[:, None, None])).float()
    check(value.to(card), mask.to(card), shared_bits=shared_bits)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(card, monkeypatch):
    """A CUDA tensor launches K2: the plain version is never called."""
    value, mask = ragged(2, 9, 30, card)
    want = mas.maximum_path_torch(value, mask)

    def refuse(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mas, "maximum_path_torch", refuse)
    launches = mas.maximum_path.launches
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert mas.maximum_path.launches == launches + 1 and torch.equal(got, want)


@pytest.mark.cuda
def test_refuses_what_the_kernel_does_not_take(card):
    value, mask = ragged(2, 9, 30, card)
    with pytest.raises(TypeError):
        mas.maximum_path(value.double(), mask)
    with pytest.raises(ValueError):
        mas.maximum_path(value, mask[:, :5])
    with pytest.raises(ValueError):
        mas.maximum_path(value, mask.cpu())
