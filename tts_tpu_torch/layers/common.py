"""Common conv/norm blocks (port of ``tts_tpu/layers/common.py``): ``Conv1d``,
``LayerNorm`` and ``DurationPredictor``, inference only (no dropout).

``Conv1d`` runs on channel-first ``[B, C, T]`` as torch's convolutions do;
``LayerNorm`` normalises the last axis of a time-major ``[B, T, C]`` tensor,
the JAX package's layout. Each block moves between the two explicitly.
Parameter names follow the JAX modules' (``utils.convert.flax_to_state_dict``
drops the ``Conv_0``/``LayerNorm_0`` wrapper level of their flax trees).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with torch-style symmetric padding ``(k*d - d)//2`` on
    both sides (length-preserving for odd kernels)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         padding=(kernel_size * dilation - dilation) // 2, groups=groups)


class LayerNorm(nn.LayerNorm):
    """Layer norm over the last (channel) axis with the JAX package's
    epsilon of 1e-4."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-4)


class DurationPredictor(nn.Module):
    """Token log-duration regressor: conv-relu-norm ×2 → 1 channel
    (the ``use_sdp=False`` predictor of single-speaker VITS). ``[B, T, C]``
    in, ``[B, T, 1]`` out."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int):
        super().__init__()
        self.conv_1 = Conv1d(in_channels, hidden_channels, kernel_size)
        self.norm_1 = LayerNorm(hidden_channels)
        self.conv_2 = Conv1d(hidden_channels, hidden_channels, kernel_size)
        self.norm_2 = LayerNorm(hidden_channels)
        self.proj = nn.Conv1d(hidden_channels, 1, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x, mask = x.transpose(1, 2), x_mask.transpose(1, 2)  # [B, C, T]
        for conv, norm in ((self.conv_1, self.norm_1), (self.conv_2, self.norm_2)):
            x = F.relu(conv(x * mask))
            x = norm(x.transpose(1, 2)).transpose(1, 2)
        return (self.proj(x * mask) * mask).transpose(1, 2)  # [B, T, 1] log durations
