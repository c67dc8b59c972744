"""Sequence helpers (port of ``tts_tpu/ops/helpers.py``): ``sequence_mask``
and ``generate_path``, which VITS inference calls; ``segment``,
``rand_segments`` and ``average_over_durations``, which training calls.
Values are time-major ``[B, T, C]`` as in the JAX package. The attention
prior helpers, ``beta_binomial_prior_distribution`` and
``compute_attn_prior``, are host numpy for the data pipeline
(``data/dataset.py``), copied unchanged.

``rand_segments`` draws its uniforms through :func:`uniform`, from an
explicit generator; tests replace that one function to replay the JAX
package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def uniform(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` from ``generator``, on the generator's
    device."""
    return torch.rand(shape, generator=generator, device=generator.device)


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


def segment(x: torch.Tensor, segment_indices: torch.Tensor, segment_size: int,
            pad_short: bool = False) -> torch.Tensor:
    """``segment_size`` frames of each row of ``x [B, T, C]`` from its start
    index ``[B]`` → ``[B, segment_size, C]`` (differentiable in ``x``). A
    start past ``T - segment_size`` is moved back to it, as the JAX
    package's ``dynamic_slice`` clamps; with ``pad_short`` a shorter ``x`` is
    zero-padded to ``segment_size`` first (port of
    ``tts_tpu/ops/helpers.py:44-72``)."""
    if pad_short and x.shape[1] < segment_size:
        x = F.pad(x, (0, 0, 0, segment_size - x.shape[1]))
    T = x.shape[1]
    if T < segment_size:
        raise ValueError(f"segment: {segment_size} frames from a sequence of {T}")
    start = torch.clamp(segment_indices.long(), 0, T - segment_size)
    pos = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], pos]


def rand_segments(generator: torch.Generator, x: torch.Tensor,
                  x_lengths: Optional[torch.Tensor] = None, segment_size: int = 4,
                  let_short_samples: bool = False,
                  pad_short: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random ``segment_size`` window of each row of ``x [B, T, C]`` inside
    its length → ``(segments [B, segment_size, C], start indices [B] int32)``.
    The start is ``floor(u * (length - segment_size + 1))`` for a uniform
    ``u`` from :func:`uniform` (port of ``tts_tpu/ops/helpers.py:75-106``)."""
    B, T, _ = x.shape
    if pad_short and T < segment_size:
        x = F.pad(x, (0, 0, 0, segment_size - T))
        T = segment_size
    if x_lengths is None:
        x_lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    len_diff = x_lengths.to(torch.int32) - segment_size
    if let_short_samples or pad_short:
        len_diff = torch.clamp(len_diff, min=0)
    u = uniform((B,), generator).to(x.device)
    segment_indices = (u * (len_diff + 1)).to(torch.int32)
    return segment(x, segment_indices, segment_size, pad_short=pad_short), segment_indices


def average_over_durations(values: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Frame values ``[B, T_de, C]`` averaged over each token's frames
    (``durs [B, T_en]``), zeros counting as unset → ``[B, T_en, C]`` (port
    of ``tts_tpu/ops/helpers.py:109-128``)."""
    durs_ends = torch.cumsum(durs, dim=1)
    durs_starts = F.pad(durs_ends[:, :-1], (1, 0))
    nonzero = (values != 0.0).to(values.dtype)
    csum = F.pad(torch.cumsum(values, dim=1), (0, 0, 1, 0))
    cnum = F.pad(torch.cumsum(nonzero, dim=1), (0, 0, 1, 0))
    ends = torch.clamp(durs_ends, 0, values.shape[1]).long()[:, :, None].expand(
        -1, -1, values.shape[2])
    starts = torch.clamp(durs_starts, 0, values.shape[1]).long()[:, :, None].expand(
        -1, -1, values.shape[2])
    sums = torch.gather(csum, 1, ends) - torch.gather(csum, 1, starts)
    nelems = torch.gather(cnum, 1, ends) - torch.gather(cnum, 1, starts)
    return torch.where(nelems == 0.0, 0.0, sums / torch.clamp(nelems, min=1.0))


# ---------------------------------------------------------------------------
# host-side priors (numpy; the dataset's attention prior, port of
# tts_tpu/ops/helpers.py:156-174)
# ---------------------------------------------------------------------------


def beta_binomial_prior_distribution(
    phoneme_count: int, mel_count: int, scaling_factor: float = 1.0
) -> np.ndarray:
    """Beta-binomial alignment prior ``[mel_count, phoneme_count]``
    (reference ``helpers.py:240-250``)."""
    from scipy.stats import betabinom

    P, M = phoneme_count, mel_count
    x = np.arange(0, P)
    rows = []
    for i in range(1, M + 1):
        a, b = scaling_factor * i, scaling_factor * (M + 1 - i)
        rows.append(betabinom(P, a, b).pmf(x))
    return np.array(rows)


def compute_attn_prior(x_len: int, y_len: int, scaling_factor: float = 1.0) -> np.ndarray:
    """[y_len, x_len] attention prior (reference ``helpers.py:253``)."""
    return beta_binomial_prior_distribution(x_len, y_len, scaling_factor)
