"""Sequence helpers (port of ``tts_tpu/ops/helpers.py``): ``sequence_mask``
and ``generate_path``, which VITS inference calls. Values are time-major
``[B, T, C]`` as in the JAX package. The segment, prior and
duration-averaging helpers serve training and wait for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(sequence_lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean padding mask ``[B, T_max]``: ``mask[b, t] = t < lengths[b]``."""
    seq_range = torch.arange(max_len, device=sequence_lengths.device)
    return seq_range[None, :] < sequence_lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic hard-attention path from durations: ``path[b, x, y] = 1``
    iff frame ``y`` belongs to token ``x``, i.e. ``cum[x-1] <= y < cum[x]``.

    ``duration`` ``[B, T_en]``, ``mask`` ``[B, T_en, T_de]``; returns the
    ``[B, T_en, T_de]`` path in ``mask``'s dtype.
    """
    t_y = mask.shape[2]
    cum_duration = torch.cumsum(duration, dim=1)  # [B, T_en]
    cum_prev = F.pad(cum_duration[:, :-1], (1, 0))
    y_range = torch.arange(t_y, device=duration.device)[None, None, :]
    path = (y_range < cum_duration[:, :, None]) & (y_range >= cum_prev[:, :, None])
    return path.to(mask.dtype) * mask
