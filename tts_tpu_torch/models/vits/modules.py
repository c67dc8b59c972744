"""VITS network modules (port of ``tts_tpu/models/vits/modules.py``) for
inference, time-major ``[B, T, C]`` like the JAX package, with the speaker
(``g``) and language (``lang_emb``) conditioning of multi-speaker and
multi-language models.

Every parameter of the JAX modules' inference path has its counterpart
here, under the same name, so converted weights load strictly. The coupling
flows run in both directions: their inverse (``reverse=True``, the default
here) for text-to-speech, and their forward direction after the posterior
encoder for voice conversion (``models/vits/model.py``). The stochastic
duration predictor's training direction, its posterior flows and the
discriminator wait for training.

The duration predictors read the text encoder's output, whose width is
``hidden_channels`` plus the language embedding's, as the reference's do
and as the JAX package's inference feeds them; the JAX package sizes their
input layer from its training forward, which feeds the prior means
(``hidden_channels`` wide), so a JAX multi-language model cannot run
inference on its own initial parameters (ROADMAP.md F12).

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
                 hidden_channels_ffn: int, num_heads: int, num_layers: int, kernel_size: int,
                 language_emb_dim: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        width = hidden_channels + language_emb_dim  # the language joins every token
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = RelativePositionTransformer(
            width, hidden_channels_ffn, num_heads, num_layers, kernel_size,
            rel_attn_window_size=4,
        )
        self.proj = nn.Linear(width, out_channels * 2)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                lang_emb: Optional[torch.Tensor] = None):
        h = self.emb(x) * math.sqrt(self.hidden_channels)
        if lang_emb is not None:  # [B, C_l] → concatenated to every token
            h = torch.cat([h, lang_emb[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(h.dtype)
        h = self.encoder(h * x_mask, x_mask)
        m, logs = torch.chunk(self.proj(h) * x_mask, 2, dim=-1)
        return h, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear-spec → latent posterior via WaveNet (reference ``networks.py:235``)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, num_layers: int, cond_channels: int = 0):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.proj = nn.Linear(hidden_channels, out_channels * 2)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None, g: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None):
        """Spectrogram ``[B, T, C_spec]`` → ``(z, mean, log_scale, mask)``;
        the sample ``z`` takes ``noise`` (``[B, T, C]``) where given, else a
        draw from ``generator`` (port of ``tts_tpu/models/vits/modules.py:72-101``)."""
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask, g=g)
        mean, log_scale = torch.chunk(self.proj(h) * x_mask, 2, dim=-1)
        if noise is None:
            noise = normal(mean.shape, generator)
        z = (mean + noise * torch.exp(log_scale)) * x_mask
        return z, mean, log_scale, x_mask


class ResidualCouplingBlock(nn.Module):
    """Mean-only affine coupling with WN transform (reference ``networks.py:78``),
    in both directions."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int, cond_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Linear(self.half, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.post = nn.Linear(hidden_channels, self.half)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = True) -> torch.Tensor:
        x0, x1 = x[..., : self.half], x[..., self.half :]
        m = self.post(self.enc(self.pre(x0) * x_mask, x_mask, g=g)) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1)


class ResidualCouplingBlocks(nn.Module):
    """Stack of coupling blocks with channel flips (reference ``networks.py:169``;
    port of ``tts_tpu/models/vits/modules.py:103-180``): forward, each block
    then a flip; inverse (``reverse=True``), the blocks in reverse order, each
    after a flip."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int, num_flows: int = 4,
                 cond_channels: int = 0):
        super().__init__()
        self.flow = nn.ModuleList(
            ResidualCouplingBlock(channels, hidden_channels, kernel_size, dilation_rate,
                                  num_layers, cond_channels)
            for _ in range(num_flows)
        )

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = True) -> torch.Tensor:
        """``g``: ``[B, C_g]`` or per frame ``[B, T, C_g]`` (a packed grid)."""
        if not reverse:
            for block in self.flow:
                x = torch.flip(block(x, x_mask, g=g, reverse=False), dims=[-1])
            return x
        for block in reversed(self.flow):
            x = block(torch.flip(x, dims=[-1]), x_mask, g=g)
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
    log-durations from noise through the inverted flows. A speaker vector
    ``g`` (``cond_channels``) and a language embedding (``language_emb_dim``)
    are added to every frame after ``pre``, each through its own linear."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 num_flows: int = 4, cond_channels: int = 0, language_emb_dim: int = 0):
        super().__init__()
        if cond_channels:
            self.cond = nn.Linear(cond_channels, hidden_channels)
        if language_emb_dim:
            self.cond_lang = nn.Linear(language_emb_dim, hidden_channels)
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
                noise_scale: float = 1.0, g: Optional[torch.Tensor] = None,
                lang_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.pre(x)
        if g is not None:
            x = x + self.cond(g)[:, None, :]
        if lang_emb is not None:
            x = x + self.cond_lang(lang_emb)[:, None, :]
        x = self.proj(self.convs(x, x_mask)) * x_mask
        # the flows run backwards from noise, without the extra flow
        # ``flow[0]`` (reference :224)
        flows = list(reversed(self.flow))[:-1] + [self.flow_affine]
        z = normal((x.shape[0], x.shape[1], 2), generator) * noise_scale
        for flow in flows:
            z = flow(torch.flip(z, dims=[-1]), x_mask, g=x)
        return z[..., :1]  # log-durations [B, T, 1]
