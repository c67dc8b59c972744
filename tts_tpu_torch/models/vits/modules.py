"""VITS network modules (port of ``tts_tpu/models/vits/modules.py``),
time-major ``[B, T, C]`` like the JAX package, with the speaker (``g``) and
language (``lang_emb``) conditioning of multi-speaker and multi-language
models, and the discriminator (``VitsDiscriminator``) of training.

Every parameter of the JAX modules has its counterpart here, under the same
name, so converted weights load strictly. The coupling flows run in both
directions: their inverse (``reverse=True``, the default here) for
text-to-speech, and their forward direction after the posterior encoder for
training and voice conversion (``models/vits/model.py``). The duration
flows (``ElementwiseAffine``, ``ConvFlow``) return ``(y, logdet)`` in the
forward direction, and the stochastic duration predictor's training
direction (:meth:`StochasticDurationPredictor.nll`) returns each row's
duration NLL. Dropout (text encoder, duration predictors) acts in training
mode only (``layers.common.Dropout``).

The duration predictors read the text encoder's output, whose width is
``hidden_channels`` plus the language embedding's, as the reference's do
and as the JAX package's inference feeds them; the JAX package sizes their
input layer from its training forward, which feeds the prior means
(``hidden_channels`` wide), so a JAX multi-language model cannot run
inference on its own initial parameters (ROADMAP.md F12).

All noise comes from :func:`normal`, one draw per call, in the JAX package's
order: at inference the duration predictor's ``[B, T_x, 2]`` first, then the
prior's ``[B, frames, C]`` (``model.py``); in training the posterior's
``[B, T_y, C]``, then the duration posterior's ``[B, T_x, 2]``. Tests
replace that one function to replay the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.layers.common import Conv1d, Dropout, LayerNorm
from tts_tpu_torch.layers.transformer import RelativePositionTransformer
from tts_tpu_torch.layers.wavenet import WN
from tts_tpu_torch.ops.helpers import sequence_mask
from tts_tpu_torch.vocoder.models.hifigan_discriminator import DiscriminatorP, DiscriminatorS

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
                 language_emb_dim: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        width = hidden_channels + language_emb_dim  # the language joins every token
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = RelativePositionTransformer(
            width, hidden_channels_ffn, num_heads, num_layers, kernel_size,
            rel_attn_window_size=4, dropout_p=dropout_p,
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
    """DDS conv stack (reference ``stochastic_duration_predictor.py:9``), a
    dropout after each layer."""

    def __init__(self, channels: int, kernel_size: int, num_layers: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout_p)
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
            x = x + self.dropout(y)
        return x * x_mask


class ElementwiseAffine(nn.Module):
    """Learned per-channel affine flow (reference ``:58``): the inverse
    (``reverse=True``) returns ``x``; the forward direction returns ``(y,
    logdet [B])`` (port of ``tts_tpu/models/vits/modules.py:213-227``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.translation = nn.Parameter(torch.zeros(channels))
        self.log_scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = True):
        if not reverse:
            y = (x * torch.exp(self.log_scale) + self.translation) * x_mask
            return y, torch.sum(self.log_scale * x_mask, dim=(1, 2))
        return (x - self.translation) * torch.exp(-self.log_scale) * x_mask


class ConvFlow(nn.Module):
    """Spline coupling flow over 2 channels (reference ``:75``): the inverse
    (``reverse=True``) returns ``x``; the forward direction returns ``(y,
    logdet [B])`` (port of ``tts_tpu/models/vits/modules.py:230-276``)."""

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

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = True):
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
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, uw, uh, ud, inverse=reverse, tails="linear", tail_bound=self.tail_bound
        )
        y = torch.cat([x0, x1], dim=-1) * x_mask
        if reverse:
            return y
        return y, torch.sum(logabsdet * x_mask, dim=(1, 2))


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model (reference ``:133``): inference samples
    log-durations from noise through the inverted flows; training
    (:meth:`nll`) scores the durations of an alignment. A speaker vector
    ``g`` (``cond_channels``) and a language embedding (``language_emb_dim``)
    are added to every frame after ``pre``, each through its own linear."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 num_flows: int = 4, cond_channels: int = 0, language_emb_dim: int = 0,
                 dropout_p: float = 0.0):
        super().__init__()
        if cond_channels:
            self.cond = nn.Linear(cond_channels, hidden_channels)
        if language_emb_dim:
            self.cond_lang = nn.Linear(language_emb_dim, hidden_channels)
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.proj = nn.Linear(hidden_channels, hidden_channels)
        self.flow_affine = ElementwiseAffine(2)
        self.flow = nn.ModuleList(ConvFlow(2, hidden_channels, kernel_size, 3)
                                  for _ in range(num_flows))
        # the posterior side serves the training direction only
        self.post_pre = nn.Linear(1, hidden_channels)
        self.post_convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.post_proj = nn.Linear(hidden_channels, hidden_channels)
        self.post_flow_affine = ElementwiseAffine(2)
        self.post_flow = nn.ModuleList(ConvFlow(2, hidden_channels, kernel_size, 3)
                                       for _ in range(num_flows))

    def _condition(self, x, x_mask, g=None, lang_emb=None) -> torch.Tensor:
        x = self.pre(x)
        if g is not None:
            x = x + self.cond(g)[:, None, :]
        if lang_emb is not None:
            x = x + self.cond_lang(lang_emb)[:, None, :]
        return self.proj(self.convs(x, x_mask)) * x_mask

    def nll(self, x: torch.Tensor, x_mask: torch.Tensor, dr: torch.Tensor,
            generator: torch.Generator, g: Optional[torch.Tensor] = None,
            lang_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training direction: the durations ``dr [B, T, 1]`` (frames a
        token) scored against ``x [B, T, C]`` → each row's NLL ``[B]``, the
        variational bound of the flow's likelihood over the posterior noise
        (one draw from :func:`normal`; port of
        ``tts_tpu/models/vits/modules.py:339-378``)."""
        x = self._condition(x, x_mask, g, lang_emb)
        h = self.post_proj(self.post_convs(self.post_pre(dr), x_mask)) * x_mask
        noise = normal((dr.shape[0], dr.shape[1], 2), generator) * x_mask
        z_q = noise
        logdet_q = 0.0
        for idx, flow in enumerate([self.post_flow_affine, *self.post_flow]):
            z_q, logdet = flow(z_q, x_mask, g=x + h, reverse=False)
            logdet_q = logdet_q + logdet
            if idx > 0:
                z_q = torch.flip(z_q, dims=[-1])
        z_u, z_v = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (dr - u) * x_mask
        logdet_q = logdet_q + torch.sum((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask,
                                        dim=(1, 2))
        nll_posterior = torch.sum(-0.5 * (math.log(2 * math.pi) + noise**2) * x_mask,
                                  dim=(1, 2)) - logdet_q
        z0 = torch.log(torch.clamp(z0, min=1e-5)) * x_mask
        logdet_tot = torch.sum(-z0, dim=(1, 2))
        z = torch.cat([z0, z_v], dim=-1)
        for idx, flow in enumerate([self.flow_affine, *self.flow]):
            z, logdet = flow(z, x_mask, g=x, reverse=False)
            logdet_tot = logdet_tot + logdet
            if idx > 0:
                z = torch.flip(z, dims=[-1])
        nll_flow = torch.sum(0.5 * (math.log(2 * math.pi) + z**2) * x_mask,
                             dim=(1, 2)) - logdet_tot
        return nll_flow + nll_posterior

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, generator: torch.Generator,
                noise_scale: float = 1.0, g: Optional[torch.Tensor] = None,
                lang_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._condition(x, x_mask, g, lang_emb)
        # the flows run backwards from noise, without the extra flow
        # ``flow[0]`` (reference :224)
        flows = list(reversed(self.flow))[:-1] + [self.flow_affine]
        z = normal((x.shape[0], x.shape[1], 2), generator) * noise_scale
        for flow in flows:
            z = flow(torch.flip(z, dims=[-1]), x_mask, g=x)
        return z[..., :1]  # log-durations [B, T, 1]


class VitsDiscriminator(nn.Module):
    """The scale discriminator ``disc_s`` and one period discriminator
    ``disc_p{p}`` for each of ``periods`` (reference
    ``vits/discriminator.py:50``; port of
    ``tts_tpu/models/vits/modules.py:391-418``)."""

    def __init__(self, periods=(2, 3, 5, 7, 11), width_mult: float = 1.0):
        super().__init__()
        self.names = ["disc_s"] + [f"disc_p{p}" for p in periods]
        self.disc_s = DiscriminatorS(width_mult=width_mult)
        for p in periods:
            setattr(self, f"disc_p{p}", DiscriminatorP(p, width_mult=width_mult))

    def forward(self, x_hat: Optional[torch.Tensor], x: Optional[torch.Tensor] = None):
        """Waveforms ``[B, T, 1]`` → ``(scores_hat, feats_hat, scores_real,
        feats_real)``, one entry a sub-discriminator (empty for an input
        that is ``None``). Given both, each sub-discriminator runs once on
        the two stacked along the batch."""
        both = x_hat is not None and x is not None
        stacked = torch.cat([x_hat, x]) if both else (x_hat if x_hat is not None else x)
        outs = [getattr(self, name)(stacked) for name in self.names]
        if not both:
            scores, feats = [s for s, _ in outs], [f for _, f in outs]
            return (scores, feats, [], []) if x_hat is not None else ([], [], scores, feats)
        n = x_hat.shape[0]
        return ([s[:n] for s, _ in outs], [[f[:n] for f in fs] for _, fs in outs],
                [s[n:] for s, _ in outs], [[f[n:] for f in fs] for _, fs in outs])
