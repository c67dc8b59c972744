"""VITS network modules (port of ``tts_tpu/models/vits/modules.py``) for
single-speaker inference, time-major ``[B, T, C]`` like the JAX package.

Every parameter of the single-speaker JAX modules has its counterpart here,
under the same name, so converted weights load strictly. The flows'
``forward`` runs their inverse (``reverse=True``) direction, the one
inference takes. Their training direction, the stochastic duration
predictor's posterior flows and the discriminator wait for training; the
speaker and language conditioning waits for multi-speaker VITS.

All noise comes from :func:`normal`, one draw per call, in the JAX package's
order: the duration predictor's ``[B, T_x, 2]`` first, then the prior's
``[B, frames, C]`` (``model.py``). Tests replace that one function to replay
the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.layers.common import Conv1d, LayerNorm
from tts_tpu_torch.layers.transformer import RelativePositionTransformer
from tts_tpu_torch.layers.wavenet import WN
from tts_tpu_torch.ops.helpers import sequence_mask

from .transforms import piecewise_rational_quadratic_transform


def normal(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Standard normal fp32 noise of ``shape`` from ``generator``, on the
    generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # flax's nn.gelu is the tanh approximation
    return F.gelu(x, approximate="tanh")


class TextEncoder(nn.Module):
    """Token embedding + rel-pos transformer → prior stats
    (reference ``networks.py:29``)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 hidden_channels_ffn: int, num_heads: int, num_layers: int, kernel_size: int):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = RelativePositionTransformer(
            hidden_channels, hidden_channels_ffn, num_heads, num_layers, kernel_size,
            rel_attn_window_size=4,
        )
        self.proj = nn.Linear(hidden_channels, out_channels * 2)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor):
        h = self.emb(x) * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(h.dtype)
        h = self.encoder(h * x_mask, x_mask)
        m, logs = torch.chunk(self.proj(h) * x_mask, 2, dim=-1)
        return h, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear-spec → latent posterior via WaveNet (reference ``networks.py:235``)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, num_layers: int):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers)
        self.proj = nn.Linear(hidden_channels, out_channels * 2)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, generator: torch.Generator):
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask)
        mean, log_scale = torch.chunk(self.proj(h) * x_mask, 2, dim=-1)
        z = (mean + normal(mean.shape, generator) * torch.exp(log_scale)) * x_mask
        return z, mean, log_scale, x_mask


class ResidualCouplingBlock(nn.Module):
    """Mean-only affine coupling with WN transform (reference ``networks.py:78``),
    inverse direction."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Linear(self.half, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers)
        self.post = nn.Linear(hidden_channels, self.half)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x0, x1 = x[..., : self.half], x[..., self.half :]
        m = self.post(self.enc(self.pre(x0) * x_mask, x_mask)) * x_mask
        return torch.cat([x0, (x1 - m) * x_mask], dim=-1)


class ResidualCouplingBlocks(nn.Module):
    """Stack of coupling blocks with channel flips (reference ``networks.py:169``),
    inverse direction: the blocks in reverse order, each after a flip."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int, num_flows: int = 4):
        super().__init__()
        self.flow = nn.ModuleList(
            ResidualCouplingBlock(channels, hidden_channels, kernel_size, dilation_rate,
                                  num_layers)
            for _ in range(num_flows)
        )

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        for block in reversed(self.flow):
            x = block(torch.flip(x, dims=[-1]), x_mask)
        return x


class DilatedDepthSeparableConv(nn.Module):
    """DDS conv stack (reference ``stochastic_duration_predictor.py:9``)."""

    def __init__(self, channels: int, kernel_size: int, num_layers: int):
        super().__init__()
        self.conv_sep = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=kernel_size**i, groups=channels)
            for i in range(num_layers)
        )
        self.norm1 = nn.ModuleList(LayerNorm(channels) for _ in range(num_layers))
        self.conv_1x1 = nn.ModuleList(nn.Linear(channels, channels) for _ in range(num_layers))
        self.norm2 = nn.ModuleList(LayerNorm(channels) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for conv_sep, norm1, conv_1x1, norm2 in zip(self.conv_sep, self.norm1, self.conv_1x1,
                                                    self.norm2):
            y = conv_sep((x * x_mask).transpose(1, 2)).transpose(1, 2)
            y = _gelu(norm2(conv_1x1(_gelu(norm1(y)))))
            x = x + y
        return x * x_mask


class ElementwiseAffine(nn.Module):
    """Learned per-channel affine flow (reference ``:58``), inverse direction."""

    def __init__(self, channels: int):
        super().__init__()
        self.translation = nn.Parameter(torch.zeros(channels))
        self.log_scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        return (x - self.translation) * torch.exp(-self.log_scale) * x_mask


class ConvFlow(nn.Module):
    """Spline coupling flow over 2 channels (reference ``:75``), inverse
    direction."""

    num_bins = 10
    tail_bound = 5.0

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 num_layers: int):
        super().__init__()
        self.half = in_channels // 2
        self.hidden_channels = hidden_channels
        self.pre = nn.Linear(self.half, hidden_channels)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, num_layers)
        self.proj = nn.Linear(hidden_channels, self.half * (self.num_bins * 3 - 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x0, x1 = x[..., : self.half], x[..., self.half :]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask  # [B, T, half*(3bins-1)]
        b, t, _ = x0.shape
        h = h.reshape(b, t, self.half, self.num_bins * 3 - 1)
        denom = math.sqrt(self.hidden_channels)
        uw = h[..., : self.num_bins] / denom
        uh = h[..., self.num_bins : 2 * self.num_bins] / denom
        ud = h[..., 2 * self.num_bins :]
        # spline operates elementwise on x1 [B, T, half]
        x1, _ = piecewise_rational_quadratic_transform(
            x1, uw, uh, ud, inverse=True, tails="linear", tail_bound=self.tail_bound
        )
        return torch.cat([x0, x1], dim=-1) * x_mask


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model (reference ``:133``): inference samples
    log-durations from noise through the inverted flows."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 num_flows: int = 4):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3)
        self.proj = nn.Linear(hidden_channels, hidden_channels)
        self.flow_affine = ElementwiseAffine(2)
        self.flow = nn.ModuleList(ConvFlow(2, hidden_channels, kernel_size, 3)
                                  for _ in range(num_flows))
        # the posterior side serves the training direction only
        self.post_pre = nn.Linear(1, hidden_channels)
        self.post_convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3)
        self.post_proj = nn.Linear(hidden_channels, hidden_channels)
        self.post_flow_affine = ElementwiseAffine(2)
        self.post_flow = nn.ModuleList(ConvFlow(2, hidden_channels, kernel_size, 3)
                                       for _ in range(num_flows))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, generator: torch.Generator,
                noise_scale: float = 1.0) -> torch.Tensor:
        x = self.proj(self.convs(self.pre(x), x_mask)) * x_mask
        # the flows run backwards from noise, without the extra flow
        # ``flow[0]`` (reference :224)
        flows = list(reversed(self.flow))[:-1] + [self.flow_affine]
        z = normal((x.shape[0], x.shape[1], 2), generator) * noise_scale
        for flow in flows:
            z = flow(torch.flip(z, dims=[-1]), x_mask, g=x)
        return z[..., :1]  # log-durations [B, T, 1]
