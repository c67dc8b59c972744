"""HiFiGAN's discriminators (port of
``tts_tpu/vocoder/models/hifigan_discriminator.py``; reference
``TTS/vocoder/models/hifigan_discriminator.py``): the period and scale
discriminators, as VITS training uses them
(``models/vits/modules.py::VitsDiscriminator``), and the vocoders'
``MultiPeriodDiscriminator``, ``MultiScaleDiscriminator`` (the waveform
average-pooled between scales) and ``HifiganDiscriminator`` (both).

Each takes a waveform ``[B, T, 1]`` and returns ``(score [B, n],
feature maps)``, keeping the JAX package's quirks:
- a length that the period does not divide is padded by reflection up to
  the next multiple;
- ``width_mult`` scales every channel count (at least 8), and the scale
  discriminator's group count is ``gcd(gcd(groups, c_in), c_out)`` of the
  scaled widths;
- the feature maps are time-major at the boundary, as flax computes them:
  ``[B, T', period, C]`` for a period discriminator, ``[B, T', C]`` for the
  scale one; the score flattens them in that order.
Spectral and weight norms are left out (plain kernels), as in the JAX
package. The wrappers return ``(scores, feature maps)`` as lists, one entry
a sub-discriminator; module names follow the flax modules' (``mpd``,
``msd``, ``disc_p<period>``, ``disc_s<i>``), so
``utils.convert.vocoder_discriminator_from_jax_params`` maps the JAX
parameters one to one.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def scaled(ch: int, mult: float) -> int:
    """A channel count under ``width_mult`` (at least 8; as it is at 1.0)."""
    return ch if mult == 1.0 else max(8, int(ch * mult))


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded by ``period`` into
    ``[T / period, period]`` and run through ``(k, 1)`` 2-D convolutions
    (port of ``hifigan_discriminator.py:28-67``)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 width_mult: float = 1.0):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = [1] + [scaled(c, width_mult) for c in (32, 128, 512, 1024)]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), (pad, 0))
            for i in range(4)
        )
        self.convs.append(nn.Conv2d(chans[4], scaled(1024, width_mult), (kernel_size, 1), 1,
                                    (2, 0)))
        self.conv_post = nn.Conv2d(scaled(1024, width_mult), 1, (3, 1), 1, (1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t, _ = x.shape
        h = x.transpose(1, 2)  # [B, 1, T]
        if t % self.period:
            h = F.pad(h, (0, self.period - t % self.period), mode="reflect")
        h = h.reshape(b, 1, -1, self.period)  # [B, 1, T / p, p]
        feats = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            feats.append(h.permute(0, 2, 3, 1))  # time-major [B, T', p, C]
        h = self.conv_post(h)
        feats.append(h.permute(0, 2, 3, 1))
        return h.reshape(b, -1), feats


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convolutions (port of
    ``hifigan_discriminator.py:85-115``)."""

    SPEC = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
            (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
            (1024, 5, 1, 1, 2))  # (channels, kernel, stride, groups, padding)

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.convs = nn.ModuleList()
        cin = 1
        for ch, k, s, g, p in self.SPEC:
            cout = scaled(ch, width_mult)
            self.convs.append(nn.Conv1d(cin, cout, k, s, p, groups=math.gcd(math.gcd(g, cin),
                                                                           cout)))
            cin = cout
        self.conv_post = nn.Conv1d(cin, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = x.transpose(1, 2)  # [B, 1, T]
        feats = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            feats.append(h.transpose(1, 2))  # time-major [B, T', C]
        h = self.conv_post(h)
        feats.append(h.transpose(1, 2))
        return h.reshape(h.shape[0], -1), feats


class MultiPeriodDiscriminator(nn.Module):
    """A period discriminator for each of ``periods`` (port of
    ``hifigan_discriminator.py:70-82``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), width_mult: float = 1.0):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(p, width_mult=width_mult))

    def forward(self, x: torch.Tensor):
        scores, feats = [], []
        for p in self.periods:
            score, feat = getattr(self, f"disc_p{p}")(x)
            scores.append(score)
            feats.append(feat)
        return scores, feats


def avg_pool(x: torch.Tensor, window: int = 4, stride: int = 2, pad: int = 2) -> torch.Tensor:
    """``[B, T, C]``: zeros padded on each side, then the mean of each
    ``window`` (the zeros counted), every ``stride`` samples."""
    h = F.pad(x.transpose(1, 2), (pad, pad))
    return F.avg_pool1d(h, window, stride).transpose(1, 2)


class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators at 1x, 2x and 4x downsampling, the waveform
    average-pooled before each but the first (port of
    ``hifigan_discriminator.py:123-137``)."""

    def __init__(self, n_scales: int = 3, width_mult: float = 1.0):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"disc_s{i}", DiscriminatorS(width_mult=width_mult))

    def forward(self, x: torch.Tensor):
        scores, feats = [], []
        for i in range(self.n_scales):
            if i:
                x = avg_pool(x)
            score, feat = getattr(self, f"disc_s{i}")(x)
            scores.append(score)
            feats.append(feat)
        return scores, feats


class HifiganDiscriminator(nn.Module):
    """The multi-period then the multi-scale discriminator, their scores and
    feature maps concatenated (port of ``hifigan_discriminator.py:140-158``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), n_scales: int = 3,
                 width_mult: float = 1.0):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, width_mult)
        self.msd = MultiScaleDiscriminator(n_scales, width_mult)

    def forward(self, x: torch.Tensor):
        scores_p, feats_p = self.mpd(x)
        scores_s, feats_s = self.msd(x)
        return scores_p + scores_s, feats_p + feats_s
