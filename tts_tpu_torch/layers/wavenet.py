"""Gated dilated-conv WaveNet stack (port of ``tts_tpu/layers/wavenet.py``),
inference only. Shared by the VITS posterior encoder and its coupling
flows. Time-major ``[B, T, C]`` at the boundary; the stack runs channel-first
inside, so the 1x1 ``res_skip_layer`` (a ``Linear``, as the JAX package's
Dense) is applied as a width-1 convolution. Weight norm is folded into
plain kernels by the converters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv1d


class WN(nn.Module):
    """Dilated gated-conv stack with optional global conditioning ``g``:
    ``[B, C_g]`` (a global vector) or ``[B, T, C_g]`` (per-frame features)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 num_layers: int, c_in_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        if c_in_channels:
            # one shared 1x1 conv producing all per-layer conditioning at once
            self.cond_layer = nn.Linear(c_in_channels, 2 * hidden_channels * num_layers)
        self.in_layer = nn.ModuleList(
            Conv1d(hidden_channels, 2 * hidden_channels, kernel_size, dilation=dilation_rate**i)
            for i in range(num_layers)
        )
        self.res_skip_layer = nn.ModuleList(
            nn.Linear(hidden_channels, 2 * hidden_channels if i < num_layers - 1
                      else hidden_channels)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.hidden_channels
        x = x.transpose(1, 2)  # [B, C, T]
        mask = x_mask.transpose(1, 2) if x_mask is not None else torch.ones_like(x[:, :1])
        output = torch.zeros_like(x[:, :H])
        if g is not None:
            if g.dim() == 2:
                g = g[:, None, :]
            g = self.cond_layer(g).transpose(1, 2)  # [B, 2*H*L, 1 or T]
        last = len(self.in_layer) - 1
        for i, (in_layer, res_skip_layer) in enumerate(zip(self.in_layer, self.res_skip_layer)):
            acts = in_layer(x)
            if g is not None:
                acts = acts + g[:, i * 2 * H : (i + 1) * 2 * H]
            acts = torch.tanh(acts[:, :H]) * torch.sigmoid(acts[:, H:])
            res_skip = F.conv1d(acts, res_skip_layer.weight[:, :, None], res_skip_layer.bias)
            if i < last:
                x = (x + res_skip[:, :H]) * mask
                output = output + res_skip[:, H:]
            else:
                output = output + res_skip
        return (output * mask).transpose(1, 2)
