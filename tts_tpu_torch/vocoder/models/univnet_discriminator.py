"""UnivNet's discriminator (port of
``tts_tpu/vocoder/models/univnet_discriminator.py``; reference
``TTS/vocoder/models/univnet_discriminator.py``): ``SpecDiscriminator``
(2-D convolutions over an STFT magnitude), ``MultiResSpecDiscriminator``
(three resolutions) and ``UnivnetDiscriminator`` (those, then HiFiGAN's
multi-period discriminator).

A waveform ``[B, T, 1]`` in. The magnitude ``[B, frames, bins]`` is the
image (time the first spatial axis, frequency the second), as the JAX
module lays it out; its convolutions pad as flax's ``"SAME"`` does, which
for a stride of 2 puts the odd pixel after the image, not split. Scores
flatten ``[B, frames', bins']``; feature maps are ``[B, frames', bins',
C]``, flax's layout. Module names follow the flax modules' (``mrsd``,
``mpd``, ``spec_<i>``, ``conv_<i>``, ``conv_post``), so
``utils.convert.flax_to_state_dict`` maps the JAX parameters one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.audio.torch_transforms import stft_magnitude
from tts_tpu_torch.vocoder.models.hifigan_discriminator import MultiPeriodDiscriminator

LRELU_SLOPE = 0.2
SPEC_LAYERS = ((32, (3, 9), (1, 1)), (32, (3, 9), (2, 2)), (32, (3, 9), (1, 2)),
               (32, (3, 3), (2, 2)))  # (channels, kernel, stride)


def same_conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built without padding) on ``[B, C, H, W]`` with flax's
    ``"SAME"`` padding: on each axis ``max((ceil(n / s) - 1) s + k - n, 0)``
    zeros, the smaller half before."""
    pads = []
    for n, k, s in zip(x.shape[-1:-3:-1], conv.kernel_size[::-1], conv.stride[::-1]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


class SpecDiscriminator(nn.Module):
    """2-D convolutions over one resolution's STFT magnitude (port of
    ``univnet_discriminator.py:14-33``)."""

    def __init__(self, fft_size: int = 1024, hop_length: int = 120, win_length: int = 600):
        super().__init__()
        self.stft = (fft_size, hop_length, win_length)
        cin = 1
        for i, (ch, k, s) in enumerate(SPEC_LAYERS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, k, s))
            cin = ch
        self.conv_post = nn.Conv2d(cin, 1, (3, 3))

    def forward(self, x: torch.Tensor):
        mag = stft_magnitude(x[..., 0], *self.stft)  # [B, bins, frames]
        h = mag.transpose(1, 2)[:, None]  # [B, 1, frames, bins]
        feats = []
        for i in range(len(SPEC_LAYERS)):
            h = F.leaky_relu(same_conv2d(getattr(self, f"conv_{i}"), h), LRELU_SLOPE)
            feats.append(h.permute(0, 2, 3, 1))
        score = same_conv2d(self.conv_post, h)
        feats.append(score.permute(0, 2, 3, 1))
        return score.reshape(score.shape[0], -1), feats


class MultiResSpecDiscriminator(nn.Module):
    """A spectrogram discriminator a resolution (port of
    ``univnet_discriminator.py:36-48``)."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_lengths: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240)):
        super().__init__()
        self.n = len(fft_sizes)
        for i, (f, h, w) in enumerate(zip(fft_sizes, hop_lengths, win_lengths)):
            self.add_module(f"spec_{i}", SpecDiscriminator(f, h, w))

    def forward(self, x: torch.Tensor):
        scores, feats = [], []
        for i in range(self.n):
            s, ft = getattr(self, f"spec_{i}")(x)
            scores.append(s)
            feats.append(ft)
        return scores, feats


class UnivnetDiscriminator(nn.Module):
    """The multi-resolution spectrogram discriminator, then HiFiGAN's
    multi-period one (port of ``univnet_discriminator.py:51-59``)."""

    def __init__(self):
        super().__init__()
        self.mrsd = MultiResSpecDiscriminator()
        self.mpd = MultiPeriodDiscriminator()

    def forward(self, x: torch.Tensor):
        s1, f1 = self.mrsd(x)
        s2, f2 = self.mpd(x)
        return s1 + s2, f1 + f2
