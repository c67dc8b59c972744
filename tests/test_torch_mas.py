"""K2's plain version (``tts_tpu_torch.ops.mas.maximum_path_torch``, what
``maximum_path`` runs on CPU tensors) against the JAX package's
``maximum_path`` and its numpy oracle ``maximum_path_numpy``, on the CPU.

The paths must be identical, not within a tolerance: both sides run the
forward pass in fp32 with the same operations in the same order, so a tie
falls the same way. Inputs: random scores, tied ones (integer-valued, so
that many sums are equal), ragged token and frame lengths, more tokens
than frames (``T_x > T_y``: the late tokens cannot be reached), length-1
rows and columns, an item whose mask is empty (zero path), bf16 values and
a boolean mask. The kernel itself runs only on a card
(``tests/test_torch_mas_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.ops.mas import maximum_path as jax_maximum_path
from tts_tpu.ops.mas import maximum_path_numpy
from tts_tpu_torch.ops import mas


def ragged_case(B, T_x, T_y, tied=False, seed=0, empty=()):
    """Scores ``[B, T_x, T_y]`` and the mask of random lengths (row 0 full);
    the rows in ``empty`` get no token at all."""
    rs = np.random.RandomState(seed)
    value = rs.randn(B, T_x, T_y).astype(np.float32) * 3
    if tied:
        value = np.round(value).astype(np.float32)
    x_len = rs.randint(1, T_x + 1, B)
    y_len = rs.randint(1, T_y + 1, B)
    x_len[0], y_len[0] = T_x, T_y
    x_len[list(empty)] = 0
    mask = ((np.arange(T_x)[None, :, None] < x_len[:, None, None])
            & (np.arange(T_y)[None, None, :] < y_len[:, None, None])).astype(np.float32)
    return value, mask


CASES = {  # name: (B, T_x, T_y, tied)
    "random": (4, 13, 40, False),
    "tied": (4, 13, 40, True),
    "tokens_past_frames": (3, 20, 9, False),  # T_x > T_y
    "one_token": (3, 1, 17, False),
    "one_frame": (3, 6, 1, True),
    "square_tied": (2, 16, 16, True),
    "wide": (2, 45, 120, False),  # more than one 32-token word of bits
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_equals_jax_and_numpy(name):
    B, T_x, T_y, tied = CASES[name]
    value, mask = ragged_case(B, T_x, T_y, tied=tied, seed=len(name))
    want_jax = np.asarray(jax_maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    want_np = maximum_path_numpy(value, mask)
    got = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, T_x, T_y)
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), want_np)
    # a monotonic path: one token a valid frame, every valid frame covered
    assert np.all(got.numpy().sum(1) == mask.max(1))


def test_empty_item_gives_zeros():
    """An item with no token has start index -1: its path is all zeros, as
    in the JAX package; the other items are unaffected."""
    value, mask = ragged_case(3, 8, 20, seed=3, empty=(1,))
    got = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_maximum_path(jnp.asarray(value),
                                                                   jnp.asarray(mask))))
    assert not got[1].any() and got[0].any()


def test_bf16_values_and_bool_mask():
    """The path comes back in value's dtype (bf16 under autocast), computed
    in fp32 from the bf16 values; a boolean mask reads as 0/1."""
    value, mask = ragged_case(3, 10, 30, seed=5)
    v16 = torch.from_numpy(value).to(torch.bfloat16)
    got = mas.maximum_path(v16, torch.from_numpy(mask).bool())
    assert got.dtype == torch.bfloat16
    want = jax_maximum_path(jnp.asarray(v16.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(mask))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_no_gradient_and_strided_input():
    """The path carries no gradient, and a non-contiguous view gives the
    contiguous input's path."""
    value, mask = ragged_case(2, 7, 15, seed=7)
    v = torch.from_numpy(value).transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
    assert not v.is_contiguous()
    got = mas.maximum_path(v, torch.from_numpy(mask))
    assert not got.requires_grad
    assert torch.equal(got, mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)))


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: a ``meta``
    tensor (no card here) is refused before any plain code runs."""
    def refuse(*args):
        raise AssertionError("the plain version ran on a non-CPU tensor")

    monkeypatch.setattr(mas, "maximum_path_torch", refuse)
    value = torch.empty(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mas.maximum_path(value, value)


def test_direction_words():
    """381 tokens × 861 frames: 12 words a frame, 41.3 KB of bits, the
    recipe's longest item (it fits the card's shared memory)."""
    assert mas.direction_words(381, 861) == 12 * 861
    assert 4 * mas.direction_words(381, 861) == 41328


# ---- the ring kernel's plan (plain Python: what the wrapper hands the kernel) ----

H100_SHARED = 232448  # bytes of shared memory a block may opt into on an H100

PLAN_SHAPES = [  # (T_x, T_y): the recipe, the aligners' width, the card tests' edges
    (381, 861), (190, 861), (13, 40), (1, 17), (6, 1), (33, 64), (100, 300), (385, 75),
    (513, 99), (1030, 861), (1536, 20), (200, 9000), (1, 10000), (5, 1000),
]


def plan_invariants(plan, T_x, T_y):
    slots = plan.scoring_warps * 32 * plan.k
    assert slots == plan.slots >= T_x  # every token has a slot, with the least k that does it
    smaller = [k for k in mas.RING_K if k < plan.k]
    assert not smaller or plan.scoring_warps * 32 * smaller[-1] < T_x
    assert plan.k in mas.RING_K and 1 <= plan.scoring_warps <= mas.RING_MAX_SCORING
    assert 1 <= plan.copying_warps and plan.scoring_warps + plan.copying_warps <= mas.RING_WARPS
    assert plan.frames in (8, 16, 32)
    tiles = -(-T_y // plan.frames)
    assert 1 <= plan.stages <= min(mas.RING_MAX_STAGES, tiles)
    assert plan.stages >= min(mas.RING_MIN_STAGES, tiles)
    # the padded row holds every slot and puts a copy instruction's 32 stores on 32 banks
    assert plan.pad >= slots and plan.pad % 32 == (32 // plan.frames) % 32
    ring = 8 * plan.stages * plan.frames * plan.pad
    bits = 4 * -(-T_y // 32) * slots
    header = -(-36 * plan.scoring_warps // 16) * 16
    assert plan.smem_bytes == 16 * plan.stages + header + ring + (bits if plan.bits_shared else 0)
    assert plan.smem_bytes <= H100_SHARED
    walk = -(-4 * (T_x + 2) // 16) * 16
    assert plan.bits_copied == (not plan.bits_shared and walk + bits <= ring)
    assert plan.bit_words(T_y) * 4 == bits
    assert len(plan.as_ints()) == 9


@pytest.mark.parametrize("T_x,T_y", PLAN_SHAPES)
def test_ring_plan_fits_the_card(T_x, T_y):
    """Every plan covers the text, keeps the kernel's bounds and fits the
    H100's 227 KB a block, its bytes summed as the kernel lays them out."""
    plan_invariants(mas.ring_plan(T_x, T_y, H100_SHARED), T_x, T_y)


def test_ring_plan_at_the_recipe():
    """B=32 x 381 x 861: one scoring warp of 12 tokens a lane, two 32-frame
    tiles (97 KB each), so the 41.5 KB of bits go to the scratch buffer and
    come back into the freed ring for the walk; forced into shared memory,
    the ring shrinks to three 16-frame tiles."""
    plan = mas.ring_plan(381, 861, H100_SHARED)
    assert (plan.k, plan.scoring_warps, plan.copying_warps, plan.frames, plan.stages) == (
        12, 1, 3, 32, 2)
    assert not plan.bits_shared and plan.bits_copied and plan.pad == 385
    shared = mas.ring_plan(381, 861, H100_SHARED, shared_bits=True)
    assert shared.bits_shared and (shared.frames, shared.stages) == (16, 3)
    plan_invariants(shared, 381, 861)
    assert mas.ring_plan(381, 861, H100_SHARED, shared_bits=False) == plan
    aligner = mas.ring_plan(190, 861, H100_SHARED)
    assert (aligner.k, aligner.frames, aligner.stages, aligner.bits_shared) == (6, 32, 4, True)


def test_ring_plan_bits_placement():
    """Bits too many for shared memory go to scratch unasked; walked there
    when the freed ring cannot take them either; forcing them into shared
    memory then raises."""
    plan = mas.ring_plan(200, 9000, H100_SHARED)
    assert not plan.bits_shared and not plan.bits_copied
    with pytest.raises(ValueError, match="do not fit"):
        mas.ring_plan(200, 9000, H100_SHARED, shared_bits=True)


@pytest.mark.parametrize("T_x", [1600, 4200])
def test_ring_plan_hands_long_texts_to_the_columns_kernel(T_x):
    """Past 1,536 tokens two 8-frame tiles no longer fit: no plan, and the
    wrapper launches the columns kernel."""
    assert mas.ring_plan(T_x, 12, H100_SHARED) is None


@pytest.mark.parametrize("warps,frames,stages", [(4, None, None), (2, 16, None),
                                                 (1, 8, 3), (3, 32, None)])
def test_ring_plan_overrides(warps, frames, stages):
    """The measurement overrides: scoring warps (k shrinks to cover the text
    with them), frames a tile, tiles in the ring."""
    plan = mas.ring_plan(381, 861, H100_SHARED, scoring_warps=warps, frames=frames,
                         stages=stages)
    assert plan.scoring_warps == warps and plan.slots >= 381
    assert frames is None or plan.frames == frames
    assert stages is None or plan.stages == stages
    plan_invariants(plan, 381, 861)
