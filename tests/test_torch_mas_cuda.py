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
in the global scratch buffer instead of shared memory. Then the ring
kernel's boundaries: token counts at 32k ± 1 (a lane's tokens, a warp's
512), 1024 ± 1 and 1030 (several scoring warps); frame counts off the
tile's and wrapping the ring many times; every frames-a-tile and up to four
scoring warps forced through its plan; items whose bits leave shared memory
unasked (copied back into the ring for the walk, or walked in the scratch
buffer); unaligned views; and a text longer than the ring kernel takes
(the columns kernel).
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
@pytest.mark.parametrize("shared_bits", [None, False, True], ids=["planned", "scratch", "shared"])
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


BOUNDARY_TOKENS = [31, 33, 63, 65, 191, 193, 383, 385, 511, 513, 1023, 1025, 1030]


@pytest.mark.cuda
@pytest.mark.parametrize("T_x", BOUNDARY_TOKENS)
def test_token_boundaries(card, T_x):
    """Lanes of 2-16 tokens, one scoring warp up to 512 tokens and several
    past it; 75 frames: past T_x for the short texts, off the 8-frame tile."""
    check(*ragged(2, T_x, 75, card, tied=T_x % 2 == 1, seed=T_x))


@pytest.mark.cuda
@pytest.mark.parametrize("T_x,T_y", [(20, 203), (381, 861), (100, 1), (40, 9), (5, 1000)])
def test_ring_wraps(card, T_x, T_y):
    """Frame counts that end mid-tile, one frame, and many rounds of the
    ring (861 frames in 7 tiles of 8; 1000 frames of a 5-token text)."""
    check(*ragged(3, T_x, T_y, card, seed=T_y))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 3, 4])
@pytest.mark.parametrize("frames", [8, 16, 32])
def test_forced_plans(card, warps, frames):
    """Every tile height the kernel takes, with 1-4 scoring warps (the
    named barrier a frame between them), the bits in shared memory; 131
    frames: 16 chunks of 8 and a tail of 3."""
    value, mask = ragged(3, 190, 131, card, tied=True, seed=frames + warps)
    plan = mas.ring_plan(190, 131, mas.shared_limit(0), scoring_warps=warps, frames=frames)
    assert plan.scoring_warps == warps and plan.frames == frames and plan.bits_shared
    got = mas.launch_ring(value, mask, plan)
    again = mas.launch_ring(value, mask, plan)
    want = mas.maximum_path_torch(value, mask)
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("T_x,T_y,copied", [(381, 861, True), (200, 9000, False)])
def test_bits_leave_shared_memory_unasked(card, T_x, T_y, copied):
    """Items whose bits do not fit beside a ring of 32-frame tiles: the plan
    puts them in the scratch buffer by itself, and copies them into the
    freed ring for the walk where they fit there."""
    plan = mas.ring_plan(T_x, T_y, mas.shared_limit(0))
    assert not plan.bits_shared and plan.bits_copied == copied
    check(*ragged(2, T_x, T_y, card, seed=T_x))


@pytest.mark.cuda
def test_unaligned_views_and_bool_mask(card):
    """Views that start off any 16-byte line with odd strides, and a bool
    mask, against the contiguous fp32 inputs."""
    value, mask = ragged(3, 45, 97, card, seed=17)
    big_v = torch.randn(3, 47, 101, device=card)
    big_v[:, 1:46, 2:99] = value
    big_m = torch.zeros(3, 47, 101, device=card, dtype=torch.bool)
    big_m[:, 1:46, 2:99] = mask > 0
    vv, mv = big_v[:, 1:46, 2:99], big_m[:, 1:46, 2:99]  # 103 elements in: 412 bytes
    assert vv.data_ptr() % 16 and not vv.is_contiguous()
    assert torch.equal(check(vv, mv), mas.maximum_path(value, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("T_x", [1600, 4200])
def test_past_the_ring_kernel(card, T_x):
    """Texts longer than the ring kernel takes: the columns kernel."""
    assert mas.ring_plan(T_x, 12, mas.shared_limit(0)) is None
    check(*ragged(2, T_x, 12, card, seed=4))


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
