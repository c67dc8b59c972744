"""Sequence-packed batch decode planning (copied from
``tts_tpu/utils/packing.py``; host numpy code).

Padding a batch of utterances of different predicted lengths to the
longest one decodes the padding too. Instead, the utterances are packed
back to back into a few dense rows, separated by short masked gaps; the
grid is decoded once and the segments are sliced back out on the host.

Exactness: the VITS flow masks after every layer and the HiFiGAN decoder
re-applies ``x_mask`` after every conv (``vocoder/models/hifigan_generator``),
so a gap of ``gap`` frames at least the largest single conv's reach makes
each packed segment convolve as its own zero-padded decode. The largest
single-conv reach in the stock architecture is the k=11 d=5 resblock conv
at the 8x stage, about 3.2 input frames; the default ``gap=8`` clears it
twice over.

Planning is first-fit-decreasing over candidate row lengths (multiples of
``len_multiple``); the plan of least billed area wins, where the row count
is billed in multiples of ``row_pad_multiple``. The JAX package bills rows
in eights, for its accelerator's tiling; the port's default,
:data:`ROW_PAD_MULTIPLE`, is the value that decoded faster on an H100
(PERF.md, ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

ROW_PAD_MULTIPLE = 1  # rows billed one by one: see the module docstring


@dataclass
class PackPlan:
    """Host-side layout of a packed decode.

    ``seg_sample[r, c]`` is the original batch index occupying packed slot
    ``(r, c)`` (``-1`` = masked gap); ``seg_pos[r, c]`` is that frame's index
    within its own utterance.  ``slices[i] = (row, start, frames)`` locates
    sample ``i``'s span for host-side unpacking.
    """

    seg_sample: np.ndarray
    seg_pos: np.ndarray
    slices: List[Tuple[int, int, int]]
    row_len: int
    n_rows: int
    total_frames: int
    gap: int = 8
    lengths: List[int] = field(default_factory=list)

    @property
    def utilization(self) -> float:
        """Fraction of the packed grid carrying real frames."""
        return self.total_frames / float(self.n_rows * self.row_len)


def _first_fit_decreasing(lens: Sequence[int], row_len: int, gap: int):
    """Place items (len + trailing gap) into rows of capacity ``row_len``.

    Returns ``placements[i] = (row, start)`` in ORIGINAL index order, and the
    row count.  An item may end flush at ``row_len`` (the trailing gap is
    only needed *between* segments; the row edge zero-pads naturally).
    """
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    cursors: List[int] = []  # next free column per row
    placements: List[Tuple[int, int]] = [(-1, -1)] * len(lens)
    for i in order:
        ln = lens[i]
        placed = False
        for r, c in enumerate(cursors):
            if c + ln <= row_len:
                placements[i] = (r, c)
                cursors[r] = c + ln + gap
                placed = True
                break
        if not placed:
            placements[i] = (len(cursors), 0)
            cursors.append(ln + gap)
    return placements, len(cursors)


def plan_pack_layout(
    y_lengths,
    gap: int = 8,
    row_len: int | None = None,
    len_multiple: int = 64,
    max_row_len: int = 8192,
    row_pad_multiple: int = ROW_PAD_MULTIPLE,
) -> PackPlan:
    """Choose a packed grid for ``y_lengths`` predicted frame counts.

    ``row_len=None`` searches candidate row lengths (one per target row
    count, rounded up to ``len_multiple``) and keeps the plan of least
    billed area, ``ceil(R / row_pad_multiple) * row_pad_multiple * L``; ties
    go to the smaller raw area, then the fewer rows.
    """
    lens = [max(1, int(v)) for v in np.asarray(y_lengths).reshape(-1)]
    n = len(lens)
    longest = max(lens)
    total = sum(lens) + gap * (n - 1)

    def _bucket(v: int) -> int:
        return min(((v + len_multiple - 1) // len_multiple) * len_multiple, max_row_len)

    if longest > max_row_len:
        raise ValueError(
            f"utterance of {longest} frames exceeds max_row_len={max_row_len}; "
            "decode it unpacked"
        )

    if row_len is not None:
        candidates = [min(max(row_len, longest), max_row_len)]
    else:
        candidates = sorted(
            {_bucket(max(longest, math.ceil(total / r))) for r in range(1, n + 1)}
        )

    def _billed_rows(r: int) -> int:
        m = max(1, int(row_pad_multiple))
        return math.ceil(r / m) * m

    best = None  # (billed_area, area, n_rows, row_len, placements)
    for cand in candidates:
        placements, n_rows = _first_fit_decreasing(lens, cand, gap)
        key = (_billed_rows(n_rows) * cand, n_rows * cand, n_rows)
        if best is None or key < best[0]:
            best = (key, n_rows, cand, placements)
    _, n_rows, chosen, placements = best

    seg_sample = np.full((n_rows, chosen), -1, np.int32)
    seg_pos = np.zeros((n_rows, chosen), np.int32)
    slices: List[Tuple[int, int, int]] = []
    for i, (r, c) in enumerate(placements):
        ln = lens[i]
        seg_sample[r, c : c + ln] = i
        seg_pos[r, c : c + ln] = np.arange(ln, dtype=np.int32)
        slices.append((r, c, ln))
    return PackPlan(
        seg_sample=seg_sample,
        seg_pos=seg_pos,
        slices=slices,
        row_len=chosen,
        n_rows=n_rows,
        total_frames=sum(lens),
        gap=gap,
        lengths=lens,
    )


def unpack_outputs(packed: np.ndarray, plan: PackPlan, upsample: int = 1) -> List[np.ndarray]:
    """Slice per-sample spans out of a packed output.

    ``packed`` is ``[R, T_out, ...]`` where ``T_out = row_len * upsample``
    (``upsample`` = samples per frame, e.g. the vocoder hop length for
    waveforms, 1 for frame-rate outputs).
    """
    packed = np.asarray(packed)
    out: List[np.ndarray] = []
    for r, start, ln in plan.slices:
        out.append(packed[r, start * upsample : (start + ln) * upsample])
    return out
