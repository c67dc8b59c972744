"""Monotonic alignment search (MAS), K2 (port of ``tts_tpu/ops/mas.py``).

``maximum_path(value, mask)`` gives the best monotonic 0/1 path through
``value [B, T_x, T_y]`` (token × frame log-likelihoods, higher is better)
under ``mask``: a forward pass over the frames keeps ``v[x]``, the best
score ending at token ``x``, and records whether the best way to ``x`` stays
on it (``v[x] >= v[x-1]``, so ties stay; tokens past the frame get −1e9),
with the direction forced to "stay" outside the mask; then a walk back from
``sum(mask[:, :, 0]) - 1``. The result is ``path * mask`` in ``value``'s
dtype and carries no gradient. The sums run in fp32 in the JAX package's
order, so the paths are identical to its ``maximum_path`` and to
``maximum_path_numpy``, not merely close. VITS training runs it once a step
(``models/vits/model.py``); GlowTTS, AlignTTS, the ForwardTTS aligner and
DelightfulTTS will.

CUDA tensors launch K2, the hand-written kernels in ``csrc/mas.cu`` (CUDA
C++ for ``sm_90a``, built by ``ops/cuda_build.py`` at first use, bound
through ``ctypes``), one launch a call, no host sync. Texts whose ring of
two 8-frame tiles fits in shared memory (1,536 tokens on an H100) take the
ring kernel: one block an item, the scores in the registers of its scoring
warps, value and mask streamed into a ring of shared-memory tiles by its
copying warps, the directions one bit a cell in shared memory (or, for
items whose bits do not fit there beside the ring, in a global scratch
buffer this wrapper allocates), the walk back over those bits alone, the
path written by the block. Its plan (:func:`ring_plan`) is plain Python.
It reads fp32: bf16 values and bf16 or bool masks are first widened by one
PyTorch conversion each (a contiguous fp32 copy; exact). Longer texts take
the columns kernel (a thread a token, the first design), which reads every
type in place. What the kernels do not take raises. CPU tensors, and only
they, take :func:`maximum_path_torch`, the plain version: a loop over
``T_y`` of vectorised ops.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .cuda_build import CudaLibrary, check_cuda, load_library

NEG = -1e9  # the JAX package's _NEG (exact in fp32)

_VALUE_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2}


@torch.no_grad()
def maximum_path_torch(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K2, on any device: the forward pass as a loop over
    the frames of ``[B, T_x]`` ops, the directions kept as booleans, then
    the walk back over the frames. Same contract as :func:`maximum_path`."""
    dtype = value.dtype
    mask_f = mask.float()
    scores = (value * mask).float()
    B, T_x, T_y = scores.shape
    dev = scores.device
    token = torch.arange(T_x, device=dev)[None, :]
    neg = torch.full((B, 1), NEG, device=dev)
    v = torch.zeros(B, T_x, device=dev)
    stay = torch.empty(B, T_x, T_y, dtype=torch.bool, device=dev)
    for j in range(T_y):
        v0 = torch.cat([neg, v[:, :-1]], dim=1)  # v[x-1]
        s = v >= v0
        stay[:, :, j] = s
        v = torch.where(token <= j, torch.where(s, v, v0) + scores[:, :, j], NEG)
    stay |= ~(mask_f > 0)  # outside the mask the walk stays

    path = torch.zeros(B, T_x, T_y, device=dev)
    rows = torch.arange(B, device=dev)
    x = mask_f[:, :, 0].sum(dim=1).to(torch.int32).long() - 1
    for j in range(T_y - 1, -1, -1):
        inside = x >= 0  # once the walk leaves the tokens it writes nothing more
        xc = x.clamp(min=0)
        path[rows, xc, j] = torch.where(inside, 1.0, path[rows, xc, j])
        x = torch.where(inside, x + stay[rows, xc, j].long() - 1, x)
    return (path * mask_f).to(dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (at first use) and bind the C entry points."""
    return bind(load_library("mas"))


def bind(built: CudaLibrary) -> tuple:
    """``(built, ring, columns, shared limit)``: the C entry points of a
    build of ``csrc/mas.cu`` with their argument types."""
    ring = built.lib.tts_maximum_path
    ring.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    ring.restype = ctypes.c_int
    columns = built.lib.tts_maximum_path_columns
    columns.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    columns.restype = ctypes.c_int
    limit = built.lib.tts_maximum_path_shared_limit
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_int
    return built, ring, columns, limit


# ---- the ring kernel's plan -------------------------------------------------

RING_K = (2, 3, 4, 6, 8, 12, 16)  # tokens a lane the ring kernel is built for
RING_WARPS = 12  # scoring + copying warps a block (the kernel's launch bound, 384 threads)
RING_MAX_SCORING = 8  # scoring warps: 8 x 32 lanes x 16 tokens
RING_MAX_STAGES = 8
RING_FRAMES = (32, 16, 8)  # frames a tile, in the order tried (the kernel runs 8-frame chunks)
RING_MIN_STAGES = 2  # tiles in the ring at least, where the item has that many
# (on an H100 the copies run at ~5.5 cycles a 128-byte line a cp.async touches,
# so the widest tiles win even at two of them: scripts/k2_probes.py, PERF.md)


@dataclass(frozen=True)
class RingPlan:
    """How the ring kernel runs one shape (``csrc/mas.cu``)."""

    k: int  # tokens a lane: lane l of scoring warp w owns tokens (32 w + l) k .. + k - 1
    scoring_warps: int
    copying_warps: int
    frames: int  # F, frames a tile
    stages: int  # S, tiles in the ring
    pad: int  # words from one frame's row of a tile to the next (>= slots)
    bits_shared: bool  # the direction bits in shared memory, else in the scratch buffer
    bits_copied: bool  # scratch bits copied into the freed ring before the walk
    smem_bytes: int  # dynamic shared memory a block

    @property
    def slots(self) -> int:  # tokens a tile's row holds, past T_x unused
        return self.scoring_warps * 32 * self.k

    def bit_words(self, T_y: int) -> int:
        """32-bit words of one item's direction bits: a word holds 32 frames
        of one token."""
        return -(-T_y // 32) * self.slots

    def as_ints(self) -> tuple:
        """The plan as the C entry point takes it."""
        return (self.k, self.scoring_warps, self.copying_warps, self.frames, self.stages,
                self.pad, int(self.bits_shared), int(self.bits_copied), self.smem_bytes)


def _pad(slots: int, frames: int) -> int:
    """The padded row: at least ``slots`` words and ``32 / F`` more than a
    multiple of 32 banks, where a copy instruction reads ``F`` (up to 32)
    consecutive frames of ``32 / F`` rows: its 32 stores then fall on 32
    banks."""
    group = 32 // min(frames, 32)
    return slots + (group - slots) % 32


def _header(W: int) -> int:
    """Bytes a block's shared memory holds besides the tiles and the bits:
    the scoring warps' last scores for 8 frames and their start counts (the
    mbarriers, 16 bytes a tile, go with the tiles)."""
    return -(-36 * W // 16) * 16


def _smem_bytes(W: int, S: int, F: int, pad: int, shared_bits: int) -> int:
    """Dynamic shared memory of a block (``RingLayout`` in ``csrc/mas.cu``):
    two mbarriers a tile, the header, the ring (which after the forward pass
    holds the path's tokens' first frames and any scratch bits copied for
    the walk), ``shared_bits`` bytes of direction bits."""
    return 16 * S + _header(W) + 8 * S * F * pad + shared_bits


def _ring(slots: int, T_y: int, budget: int, warps: int, F: int,
          stages: Optional[int]) -> Optional[tuple]:
    """(S, pad) for a ring of ``F``-frame tiles in ``budget`` bytes: at
    least ``RING_MIN_STAGES`` tiles (or all of the item's), as many as fit
    up to ``RING_MAX_STAGES`` (or ``stages``); None if they do not fit."""
    pad = _pad(slots, F)
    tiles = -(-T_y // F)
    S = min(stages or RING_MAX_STAGES, tiles,
            (budget - _header(warps)) // (2 * F * pad * 4 + 16))
    return (S, pad) if S >= min(RING_MIN_STAGES, tiles) else None


def ring_plan(T_x: int, T_y: int, smem_limit: int, shared_bits: Optional[bool] = None,
              scoring_warps: Optional[int] = None, frames: Optional[int] = None,
              stages: Optional[int] = None) -> Optional[RingPlan]:
    """The ring kernel's plan for items of ``T_x`` tokens and ``T_y`` frames
    on a card whose blocks may take ``smem_limit`` bytes of shared memory;
    None when the text is longer than the kernel takes (the columns kernel's
    then: past 1,536 tokens on an H100). One scoring warp up to 512 tokens,
    else one a 512; ``k`` the least that covers the text. The first tile
    height of ``RING_FRAMES`` whose ring fits, with the direction bits in
    shared memory if they fit there too (``shared_bits=None``), else in the
    scratch buffer (copied into the freed ring for the walk where they fit);
    ``shared_bits`` forces where they go (``True`` raises if they do not
    fit). ``scoring_warps``, ``frames`` (8, 16 or 32) and ``stages``
    override the defaults (for measurements)."""
    W = scoring_warps or max(1, -(-T_x // (32 * RING_K[-1])))
    k = next((k for k in RING_K if W * 32 * k >= T_x), None)
    if k is None or W > RING_MAX_SCORING:
        return None
    P = max(4 - W, 2) if W < 4 else 4  # a scheduler of its own for each scoring warp up to 3
    P = min(P, RING_WARPS - W)
    slots = W * 32 * k
    bits = 4 * -(-T_y // 32) * slots
    walk = -(-4 * (T_x + 2) // 16) * 16  # the walk's tokens, before any copied bits
    for F in (frames,) if frames else RING_FRAMES:
        if shared_bits is not False:
            ring = _ring(slots, T_y, smem_limit - bits, W, F, stages)
            if ring is not None:
                S, pad = ring
                return RingPlan(k, W, P, F, S, pad, True, False,
                                _smem_bytes(W, S, F, pad, bits))
        if not shared_bits:
            ring = _ring(slots, T_y, smem_limit, W, F, stages)
            if ring is not None:
                S, pad = ring
                return RingPlan(k, W, P, F, S, pad, False, walk + bits <= 8 * S * F * pad,
                                _smem_bytes(W, S, F, pad, 0))
    if shared_bits:
        raise ValueError(f"maximum_path: the direction bits of {T_x} x {T_y} do not fit in "
                         f"shared memory beside the ring")
    return None


def direction_words(T_x: int, T_y: int) -> int:
    """32-bit words of one item's direction bits in the columns kernel: a
    word per 32 tokens, a row of words per frame."""
    return T_y * ((T_x + 31) // 32)


def _check_cuda_args(value: torch.Tensor, mask: torch.Tensor) -> None:
    if value.dim() != 3 or mask.shape != value.shape:
        raise ValueError(f"maximum_path: want value and mask [B, T_x, T_y] of one shape, got "
                         f"{tuple(value.shape)} and {tuple(mask.shape)}")
    if mask.device != value.device:
        raise ValueError(f"maximum_path: mask on {mask.device}, value on {value.device}")
    if value.dtype not in _VALUE_TYPES:
        raise TypeError(f"maximum_path: the kernel takes fp32 or bf16 values, got {value.dtype}")
    if mask.dtype not in _MASK_TYPES:
        raise TypeError(f"maximum_path: the kernel takes an fp32, bf16 or bool mask, got "
                        f"{mask.dtype}")
    if min(value.shape) < 1:
        raise ValueError(f"maximum_path: empty input {tuple(value.shape)}")


def _device(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def shared_limit(device: int) -> int:
    """Bytes of dynamic shared memory a block may opt into on the card."""
    return _kernel()[3](device)


def launch_ring(value: torch.Tensor, mask: torch.Tensor, plan: RingPlan,
                stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring kernel on CUDA ``value`` and ``mask`` (checked) under
    ``plan``; ``stamps``, 16 int64 on the card, takes block 0's clock64
    stamps. Counts the launch."""
    B, T_x, T_y = value.shape
    device = _device(value)
    built, ring, _, _ = _kernel()
    dtype = value.dtype
    value = value.detach() if dtype == torch.float32 else value.detach().float()
    mask = mask.detach() if mask.dtype == torch.float32 else mask.detach().float()
    path = torch.empty((B, T_x, T_y), dtype=dtype, device=value.device)
    scratch = None if plan.bits_shared else torch.empty(B * plan.bit_words(T_y),
                                                        dtype=torch.int32, device=value.device)
    code = ring(value.data_ptr(), mask.data_ptr(), path.data_ptr(),
                0 if scratch is None else scratch.data_ptr(),
                0 if stamps is None else stamps.data_ptr(), B, T_x, T_y,
                (ctypes.c_longlong * 3)(*value.stride()), (ctypes.c_longlong * 3)(*mask.stride()),
                (ctypes.c_int * 9)(*plan.as_ints()), int(dtype == torch.bfloat16), device,
                torch._C._cuda_getCurrentRawStream(device))
    check_cuda(built, code, "maximum_path ring kernel launch")
    maximum_path.launches += 1
    return path


def launch_columns(value: torch.Tensor, mask: torch.Tensor, shared_bits: Optional[bool] = None,
                   stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The columns kernel on CUDA ``value`` and ``mask`` (checked), any of
    their types read in place; the bits in shared memory when they fit beside
    the scores (``shared_bits``: as in :func:`maximum_path`). Counts the
    launch."""
    B, T_x, T_y = value.shape
    device = _device(value)
    built, _, columns, limit = _kernel()
    words = direction_words(T_x, T_y)
    fits = 4 * (2 * T_x + words) <= limit(device)
    if shared_bits is None:
        shared_bits = fits
    elif shared_bits and not fits:
        raise ValueError(f"maximum_path: the direction bits of {T_x} x {T_y} do not fit in "
                         f"shared memory")
    value, mask = value.detach(), mask.detach()
    path = torch.empty((B, T_x, T_y), dtype=value.dtype, device=value.device)
    scratch = None if shared_bits else torch.empty(B * words, dtype=torch.int32,
                                                   device=value.device)
    code = columns(value.data_ptr(), mask.data_ptr(), path.data_ptr(),
                   0 if scratch is None else scratch.data_ptr(),
                   0 if stamps is None else stamps.data_ptr(), B, T_x, T_y,
                   (ctypes.c_longlong * 3)(*value.stride()),
                   (ctypes.c_longlong * 3)(*mask.stride()),
                   _VALUE_TYPES[value.dtype], _MASK_TYPES[mask.dtype], device,
                   torch._C._cuda_getCurrentRawStream(device))
    check_cuda(built, code, "maximum_path columns kernel launch")
    maximum_path.launches += 1
    return path


@functools.lru_cache(maxsize=256)
def _plan(T_x: int, T_y: int, smem_limit: int, shared_bits: Optional[bool]):
    return ring_plan(T_x, T_y, smem_limit, shared_bits)


def maximum_path(value: torch.Tensor, mask: torch.Tensor,
                 shared_bits: Optional[bool] = None) -> torch.Tensor:
    """Best monotonic path through ``value [B, T_x, T_y]`` under ``mask`` (the
    outer product of the token and frame masks) → 0/1 ``[B, T_x, T_y]`` in
    ``value``'s dtype, without gradient. CPU tensors take
    :func:`maximum_path_torch`; CUDA tensors launch K2 on the current stream,
    or raise. ``shared_bits`` chooses where the kernel keeps the direction
    bits (``None``: where the plan puts them, see :func:`ring_plan`;
    ``False`` forces the global scratch buffer, ``True`` shared memory, for
    tests and measurements)."""
    dev = value.device
    if dev.type == "cpu" and mask.device.type == "cpu":
        return maximum_path_torch(value, mask)
    if dev.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {dev}")
    _check_cuda_args(value, mask)
    _, T_x, T_y = value.shape
    plan = _plan(T_x, T_y, shared_limit(_device(value)), shared_bits)
    if plan is None:
        return launch_columns(value, mask, shared_bits)
    return launch_ring(value, mask, plan)


maximum_path.launches = 0  # kernel launches since the count was last reset
