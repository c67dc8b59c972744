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

CUDA tensors launch K2, the hand-written kernel in ``csrc/mas.cu`` (CUDA C++
for ``sm_90a``, built by ``ops/cuda_build.py`` at first use, bound through
``ctypes``): one block an item, a thread a token, the directions one bit a
cell in shared memory (or, for items whose bits do not fit there, in a
global scratch buffer this wrapper allocates), the walk back on one thread;
no host sync. What the kernel does not take raises. CPU tensors, and only
they, take :func:`maximum_path_torch`, the plain version: a loop over
``T_y`` of vectorised ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .cuda_build import check_cuda, load_library

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
    built = load_library("mas")
    fn = built.lib.tts_maximum_path
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    limit = built.lib.tts_maximum_path_shared_limit
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_int
    return built, fn, limit


def direction_words(T_x: int, T_y: int) -> int:
    """32-bit words of one item's direction bits: a word per 32 tokens, a
    row of words per frame."""
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


def maximum_path(value: torch.Tensor, mask: torch.Tensor,
                 shared_bits: Optional[bool] = None) -> torch.Tensor:
    """Best monotonic path through ``value [B, T_x, T_y]`` under ``mask`` (the
    outer product of the token and frame masks) → 0/1 ``[B, T_x, T_y]`` in
    ``value``'s dtype, without gradient. CPU tensors take
    :func:`maximum_path_torch`; CUDA tensors launch K2 on the current stream,
    or raise. ``shared_bits`` chooses where the kernel keeps the direction
    bits (``None``: shared memory when an item's bits fit there, else a
    global scratch buffer; ``False`` forces the buffer, for tests)."""
    dev = value.device
    if dev.type == "cpu" and mask.device.type == "cpu":
        return maximum_path_torch(value, mask)
    if dev.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {dev}")
    _check_cuda_args(value, mask)
    B, T_x, T_y = value.shape
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    built, fn, limit = _kernel()
    words = direction_words(T_x, T_y)
    fits = 4 * (2 * T_x + words) <= limit(device)
    if shared_bits is None:
        shared_bits = fits
    elif shared_bits and not fits:
        raise ValueError(f"maximum_path: the direction bits of {T_x} x {T_y} do not fit in "
                         f"shared memory")
    value, mask = value.detach(), mask.detach()
    path = torch.empty((B, T_x, T_y), dtype=value.dtype, device=dev)
    scratch = None if shared_bits else torch.empty(B * words, dtype=torch.int32, device=dev)
    vs = (ctypes.c_longlong * 3)(*value.stride())
    ms = (ctypes.c_longlong * 3)(*mask.stride())
    code = fn(value.data_ptr(), mask.data_ptr(), path.data_ptr(),
              0 if scratch is None else scratch.data_ptr(), B, T_x, T_y, vs, ms,
              _VALUE_TYPES[value.dtype], _MASK_TYPES[mask.dtype], device,
              torch._C._cuda_getCurrentRawStream(device))
    check_cuda(built, code, "maximum_path kernel launch")
    maximum_path.launches += 1
    return path


maximum_path.launches = 0  # kernel launches since the count was last reset
