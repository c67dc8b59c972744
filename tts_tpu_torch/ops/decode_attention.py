"""Single-token KV-cache decode attention: the hot op of XTTS decoding.

Replaces ``tts_tpu/ops/pallas_attention.py::decode_attention`` (the Pallas
TPU kernel). Per batch row and head: ``s = q·K/√dh``, positions at or past
``cache_len`` set to −1e9, softmax over the cache, ``p·V``. Output is fp32
``[B, H, dh]``.

On the card this launches the hand-written Hopper kernel in
``csrc/decode_attention.cu`` (CUDA C++, built by ``nvcc`` for ``sm_90a`` at
first use, bound through ``ctypes``). The op is bound by bytes, not flops:
each layer's decode step reads about ``2·B·n·H·dh·2`` bytes of bf16 K/V
(≈2.8 MB at B=1, n≈685, H=16, dh=64) for ~4 flops per element. The kernel
reads the ``[B, S, H, dh]`` cache in place through its strides, 16 bytes per
lane per key row, and nothing past the valid length. It cuts the keys into
splits across blocks (flash-decoding) so that one decode step fills the
card, and merges the splits' partial softmax states in the same launch
(see the source note). :func:`split_plan` decides the cut; the wrapper keeps
the merge's workspace, one per device and stream.

``decode_attention_torch`` is the plain PyTorch version of the function; the
wrapper uses it for tensors on the CPU, and only there.
``decode_attention_split_torch`` is the plain version of the kernel's
split-and-merge arithmetic, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from .cuda_build import check_cuda, load_library

Length = Union[int, torch.Tensor]


def decode_attention_torch(
    q: torch.Tensor,  # [B, H, dh]
    k_cache: torch.Tensor,  # [B, S, H, dh]
    v_cache: torch.Tensor,  # [B, S, H, dh]
    cache_len: Length,  # int, 0-d or [B] valid length
) -> torch.Tensor:
    """Plain version (mirrors ``decode_attention_xla``): fp32 math on the
    given values, fp32 ``[B, H, dh]`` out."""
    B, H, dh = q.shape
    S = k_cache.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) / math.sqrt(dh)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    valid = torch.arange(S, device=q.device)[None, None, :] < lens[:, None, None]
    scores = scores.masked_fill(~valid, -1e9)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v_cache.float())


# The kernel's grid holds at most one block per SM (an H100 SXM has 132): a
# block of 256 threads with all of its split's keys in flight. A grid just
# over one block per SM puts two blocks on a few SMs, and those set the
# kernel's time. A cache of at most MIN_SPLIT_KEYS keys is not split: the
# merge would cost more than the wider grid saves.
SM_COUNT = 132  # the plan's SM count for the plain split version (CPU)
MIN_SPLIT_KEYS = 96
MERGE_BATCH = 8  # partials the kernel's last block loads at once (kMergeBatch)


def _plan_keys(S: int, n: Optional[int]) -> int:
    """Keys the splits cover: ``[0, n)`` for a host length, else ``[0, S)``."""
    return S if n is None or n <= 0 else min(n, S)


def cut_keys(keys: int, splits: int) -> Tuple[int, int]:
    """``(splits, keys per split)``: ``[0, keys)`` cut into at most
    ``splits`` equal spans, the last one shorter, none empty."""
    splits = max(1, min(splits, keys))
    chunk = -(-keys // splits)
    return -(-keys // chunk), chunk


def split_plan(
    B: int, H: int, S: int, n: Optional[int] = None, sm_count: int = SM_COUNT
) -> Tuple[int, int]:
    """``(splits, keys per split)`` of the kernel's grid ``(splits, H, B)``
    on a card of ``sm_count`` SMs.

    ``n`` is the valid length when the caller gives it as a host int; the
    splits then cover exactly ``[0, n)``, with no empty one. With ``n=None``
    (per-row lengths on the device, unknown here) or ``n <= 0`` (everything
    masked: the mean of V over the cache) they cover ``[0, S)``."""
    keys = _plan_keys(S, n)
    return cut_keys(keys, min(sm_count // (B * H), -(-keys // MIN_SPLIT_KEYS)))


def decode_attention_split_torch(
    q: torch.Tensor,  # [B, H, dh]
    k_cache: torch.Tensor,  # [B, S, H, dh]
    v_cache: torch.Tensor,  # [B, S, H, dh]
    cache_len: Length,  # int, 0-d or [B] valid length
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the kernel's split-and-merge arithmetic: the keys
    cut as :func:`split_plan` cuts them, a partial softmax state
    ``(m, l, acc)`` per split (a split with no valid key has ``l = 0``), and
    the partials folded in split order, :data:`MERGE_BATCH` at a time, by the
    kernel's rule (``fold_states``): the batch's new max first, then the
    weighted sums in order. ``splits`` cuts the keys into that many splits
    in place of the plan's count. fp32 ``[B, H, dh]`` out."""
    B, H, dh = q.shape
    S = k_cache.shape[1]
    host_n = None if isinstance(cache_len, torch.Tensor) else int(cache_len)
    if splits is None:
        n_splits, chunk = split_plan(B, H, S, host_n)
    else:
        n_splits, chunk = cut_keys(_plan_keys(S, host_n), splits)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) / math.sqrt(dh)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    uniform = lens <= 0  # every position masked: equal scores over the whole cache
    n = torch.where(uniform, S, lens.clamp(max=S))
    scores = scores.masked_fill(uniform[:, None, None], 0.0)
    v = v_cache.float()
    pos = torch.arange(S, device=q.device)
    parts = []
    for s in range(n_splits):
        inside = (pos >= s * chunk) & (pos < (s + 1) * chunk) & (pos[None] < n[:, None])
        sc = scores.masked_fill(~inside[:, None, :], -math.inf)
        m_s = sc.amax(dim=-1)  # -inf for a split with no valid key
        p = torch.exp(sc - torch.where(torch.isfinite(m_s), m_s, 0.0)[..., None])
        parts.append((m_s, p.sum(dim=-1), torch.einsum("bhs,bshd->bhd", p, v)))
    m = torch.full((B, H), -math.inf, device=q.device)
    l = torch.zeros(B, H, device=q.device)
    o = torch.zeros(B, H, dh, device=q.device)
    for s0 in range(0, n_splits, MERGE_BATCH):
        batch = parts[s0 : s0 + MERGE_BATCH]
        mn = m
        for m_s, l_s, _ in batch:
            mn = torch.where(l_s > 0, torch.maximum(mn, m_s), mn)
        a = torch.where(torch.isfinite(mn), torch.exp(m - mn), 1.0)
        l, o = l * a, o * a[..., None]
        for m_s, l_s, acc_s in batch:
            w = torch.where(l_s > 0, torch.exp(m_s - mn), 0.0)
            l, o = l + l_s * w, o + acc_s * w[..., None]
        m = mn
    return o / l[..., None]


_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in one 16-byte lane load


def _check_cuda_args(q, k_cache, v_cache):
    """Raise on what the kernel does not take; return the three tensors'
    strides. Runs on every launch, so it is kept to a few comparisons."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(
            f"decode_attention: want q [B,H,dh] and caches [B,S,H,dh], got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, H, dh = q.shape
    shape = k_cache.shape
    if shape != v_cache.shape or shape[0] != B or shape[2] != H or shape[3] != dh:
        raise ValueError(
            f"decode_attention: shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}"
        )
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError(
            f"decode_attention: caches on {k_cache.device} / {v_cache.device}, q on {q.device}"
        )
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: caches are {k_cache.dtype} / {v_cache.dtype}, q is {q.dtype}"
        )
    vec = _VEC.get(q.dtype)
    if vec is None:
        raise TypeError(f"decode_attention: CUDA kernel takes fp32 or bf16, got {q.dtype}")
    lanes = dh // vec
    if dh % vec or lanes < 1 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(
            f"decode_attention: head dim {dh} must be {vec}·2^i ≤ {32 * vec} for {q.dtype}"
        )
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    # vec is a power of two: OR-ing the strides keeps any low bit one of them has
    if qs[2] != 1 or ks[3] != 1 or vs[3] != 1 or (
        qs[0] | qs[1] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1] | vs[2]
    ) % vec:
        raise ValueError(
            f"decode_attention: q, k_cache and v_cache need a contiguous head dim and "
            f"strides that are multiples of {vec} elements, got {qs}, {ks}, {vs}"
        )
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: q, k_cache and v_cache must be 16-byte aligned")
    return qs, ks, vs


_NUM_ARGS = 27
_args = (ctypes.c_longlong * _NUM_ARGS)()  # filled and passed under _launch_lock


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (at first use) and bind the C entry point, which takes its
    arguments packed in one int64 array (see ``enum Arg`` in the source)."""
    built = load_library("decode_attention")
    fn = built.lib.tts_decode_attention
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if built.lib.tts_decode_attention_num_args() != _NUM_ARGS:
        raise RuntimeError(f"decode_attention: the kernel takes "
                           f"{built.lib.tts_decode_attention_num_args()} arguments, not {_NUM_ARGS}")
    return built, fn


class _Workspace:
    """The merge's partials and per-(b, h) counters for one device and one
    stream. Launches on one stream run in order, so they may share it; two
    streams never do. The counters start at 0 and every launch leaves them at
    0, so the workspace is allocated once (grown when a launch needs more)
    and never cleared again. A buffer that is outgrown is kept, not freed:
    a launch already enqueued, or captured in a CUDA graph, still points at
    it."""

    def __init__(self):
        self.partials = None  # fp32, [B*H*splits, 2 + dh] for the largest launch
        self.counters = None  # int32, [B*H]
        self.outgrown = []
        self.floats = self.ints = 0  # their sizes, and their addresses:
        self.partials_ptr = self.counters_ptr = 0

    def pointers(self, device, n_partials: int, dh: int, n_counters: int):
        need = n_partials * (2 + dh)
        if self.floats < need:
            self.outgrown.append(self.partials)
            self.partials = torch.empty(need, dtype=torch.float32, device=device)
            self.floats, self.partials_ptr = need, self.partials.data_ptr()
        if self.ints < n_counters:
            self.outgrown.append(self.counters)
            self.counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
            self.ints, self.counters_ptr = n_counters, self.counters.data_ptr()
        ml = self.partials_ptr
        return ml, ml + 4 * 2 * n_partials, self.counters_ptr


_workspaces: Dict[Tuple[int, int], _Workspace] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: Length
) -> torch.Tensor:
    """Attention of one query token per row against the KV cache → fp32
    ``[B, H, dh]``. CPU tensors take :func:`decode_attention_torch`; CUDA
    tensors launch the Hopper kernel on the current stream, or raise."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_torch(q, k_cache, v_cache, cache_len)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    qs, ks, vs = _check_cuda_args(q, k_cache, v_cache)
    B, H, dh = q.shape
    S = k_cache.shape[1]
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device != dev:
            raise ValueError(f"decode_attention: cache_len on {cache_len.device}, q on {dev}")
        if cache_len.dtype != torch.int32:
            cache_len = cache_len.to(torch.int32)
        if cache_len.dim() == 0:
            lens, lens_stride = cache_len.reshape(1), 0
        elif cache_len.shape == (B,):
            lens, lens_stride = cache_len, cache_len.stride(0)
        else:
            raise ValueError(f"decode_attention: cache_len shape {tuple(cache_len.shape)}, B={B}")
        lens_ptr, len_scalar, host_n = lens.data_ptr(), 0, None
    else:
        lens_ptr, lens_stride, len_scalar = 0, 0, int(cache_len)
        host_n = len_scalar
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    splits, chunk = split_plan(B, H, S, host_n, _sm_count(device))

    built, fn = _kernel()
    out = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(device)
    with _launch_lock:  # several serving threads may decode at once
        ml = acc = counters = 0
        if splits > 1:
            ws = _workspaces.get((device, stream))
            if ws is None:
                ws = _workspaces[(device, stream)] = _Workspace()
            ml, acc, counters = ws.pointers(dev, B * H * splits, dh, B * H)
        _args[:] = (
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens_ptr, lens_stride,
            len_scalar, out.data_ptr(), B, S, H, dh, qs[0], qs[1],
            ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            int(q.dtype == torch.bfloat16), splits, chunk, ml, acc, counters, device, stream,
        )
        check_cuda(built, fn(_args), "decode_attention kernel launch")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches since the count was last reset
_launch_lock = threading.Lock()
