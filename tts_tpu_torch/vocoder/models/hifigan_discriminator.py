"""HiFiGAN's period and scale discriminators (port of ``DiscriminatorP``
and ``DiscriminatorS`` in ``tts_tpu/vocoder/models/hifigan_discriminator.py``;
reference ``TTS/vocoder/models/hifigan_discriminator.py``), as VITS training
uses them (``models/vits/modules.py::VitsDiscriminator``).

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
package. The multi-period and multi-scale wrappers of the vocoders wait
for vocoder training (ROADMAP.md item 17c).
"""

from __future__ import annotations

import math
from typing import List, Tuple

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
