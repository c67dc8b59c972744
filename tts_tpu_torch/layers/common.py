"""Common conv/norm blocks (port of ``tts_tpu/layers/common.py``): ``Conv1d``,
``LayerNorm``, ``ConvLayerNormBlock`` (the GlowTTS prenet) and
``DurationPredictor`` (the VITS ``use_sdp=False`` and GlowTTS predictor),
and ``Dropout``, flax's ``nn.Dropout`` for the layers that train.

``Dropout`` acts only in training mode (``module.train()``) and at a rate
above 0; its keep masks come from :func:`bernoulli`, drawn from the
generator that :func:`use_dropout_generator` gives it, never from torch's
global generator. In eval mode a layer computes exactly what it did
without it.

``Conv1d`` runs on channel-first ``[B, C, T]`` as torch's convolutions do;
``LayerNorm`` normalises the last axis of a time-major ``[B, T, C]`` tensor,
the JAX package's layout. Each block moves between the two explicitly.
Parameter names follow the JAX modules' (``utils.convert.flax_to_state_dict``
drops the ``Conv_0``/``LayerNorm_0`` wrapper level of their flax trees).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def bernoulli(shape, keep: float, generator: torch.Generator) -> torch.Tensor:
    """A boolean keep mask of ``shape``, each element True with probability
    ``keep``, drawn from ``generator`` on its device."""
    probs = torch.full(tuple(shape), keep, device=generator.device)
    return torch.bernoulli(probs, generator=generator).bool()


class Dropout(nn.Module):
    """flax's ``nn.Dropout(p)``: in training mode each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, else set to 0; at
    ``p == 1`` everything is 0. The mask is drawn by :func:`bernoulli` from
    ``self.generator``; training mode without one raises. In eval mode, or
    at ``p == 0``, the input passes unchanged and nothing is drawn."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in training mode draws from an explicit generator: "
                               "give the model one with use_dropout_generator")
        keep = 1.0 - self.p
        mask = bernoulli(x.shape, keep, self.generator).to(x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def use_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` under ``module`` draws from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


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


class ConvLayerNormBlock(nn.Module):
    """``num_layers`` × (conv → layer norm → ReLU → dropout) with a residual
    1x1 projection ``proj`` (reference ``glow_tts/glow.py:11``
    ResidualConv1dLayerNormBlock; the JAX package zero-initialises ``proj``,
    so a fresh block is the identity). ``[B, T, C]`` in and out."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int, num_layers: int, dropout_p: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = Dropout(dropout_p)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", Conv1d(in_channels if i == 0 else hidden_channels,
                                                hidden_channels, kernel_size))
            self.add_module(f"norm_{i}", LayerNorm(hidden_channels))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x_res = x
        mask = x_mask.transpose(1, 2)
        h = x.transpose(1, 2)  # [B, C, T]
        for i in range(self.num_layers):
            h = getattr(self, f"conv_{i}")(h * mask)
            h = getattr(self, f"norm_{i}")((h * mask).transpose(1, 2)).transpose(1, 2)
            h = self.dropout(F.relu(h).transpose(1, 2)).transpose(1, 2)
        return (x_res + self.proj(h).transpose(1, 2)) * x_mask


class DurationPredictor(nn.Module):
    """Token log-duration regressor: conv-relu-norm-dropout ×2 → 1 channel
    (the ``use_sdp=False`` predictor of VITS). ``[B, T, C]`` in, ``[B, T, 1]``
    out. With ``cond_channels`` a speaker vector ``g [B, C_g]`` is added to
    every frame of the input through the linear ``cond``."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 cond_channels: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout_p)
        if cond_channels:
            self.cond = nn.Linear(cond_channels, in_channels)
        self.conv_1 = Conv1d(in_channels, hidden_channels, kernel_size)
        self.norm_1 = LayerNorm(hidden_channels)
        self.conv_2 = Conv1d(hidden_channels, hidden_channels, kernel_size)
        self.norm_2 = LayerNorm(hidden_channels)
        self.proj = nn.Conv1d(hidden_channels, 1, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + self.cond(g)[:, None, :]
        x, mask = x.transpose(1, 2), x_mask.transpose(1, 2)  # [B, C, T]
        for conv, norm in ((self.conv_1, self.norm_1), (self.conv_2, self.norm_2)):
            x = F.relu(conv(x * mask))
            x = self.dropout(norm(x.transpose(1, 2))).transpose(1, 2)
        return (self.proj(x * mask) * mask).transpose(1, 2)  # [B, T, 1] log durations
