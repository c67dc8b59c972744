"""MelGAN's discriminators (port of
``tts_tpu/vocoder/models/melgan_discriminator.py``; reference
``TTS/vocoder/models/melgan_discriminator.py`` and
``melgan_multiscale_discriminator.py``): ``MelganDiscriminator`` and the
three-scale ``MelganMultiscaleDiscriminator``.

A waveform ``[B, T, 1]`` in; ``(score, feature maps)`` out, each
time-major ``[B, T', C]`` as flax computes them (the score ``[B, T', 1]``);
the multi-scale wrapper returns lists, one entry a scale, the waveform
average-pooled (zeros padded, counted in the mean) before each scale but
the first. Leaky ReLUs of slope 0.2; grouped downsampling convolutions of
``in / groups_denominator`` groups. Module names follow the flax modules'
(``conv_0``, ``conv_down_<i>``, ``conv_pre_final``, ``conv_final``,
``disc_<i>``), so ``utils.convert.flax_to_state_dict`` maps the JAX
parameters one to one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.models.hifigan_discriminator import avg_pool

LRELU_SLOPE = 0.2


class MelganDiscriminator(nn.Module):
    """One scale: a reflect-padded wide convolution, grouped strided
    downsampling convolutions, a pre-final convolution and the score (port
    of ``melgan_discriminator.py:12-63``)."""

    def __init__(self, kernel_sizes: Tuple[int, int] = (5, 3), base_channels: int = 16,
                 max_channels: int = 1024, downsample_factors: Sequence[int] = (4, 4, 4, 4),
                 groups_denominator: int = 4):
        super().__init__()
        k0 = int(np.prod(kernel_sizes))
        self.pad0 = (k0 - 1) // 2
        self.conv_0 = nn.Conv1d(1, base_channels, k0)
        self.downsample_factors = tuple(downsample_factors)
        in_ch = base_channels
        for i, df in enumerate(self.downsample_factors):
            out_ch = min(in_ch * df, max_channels)
            k = df * 10 + 1
            self.add_module(f"conv_down_{i}", nn.Conv1d(
                in_ch, out_ch, k, stride=df, padding=(k - 1) // 2,
                groups=in_ch // groups_denominator))
            in_ch = out_ch
        k1, k2 = kernel_sizes
        self.conv_pre_final = nn.Conv1d(in_ch, min(in_ch * 2, max_channels), k1,
                                        padding=(k1 - 1) // 2)
        self.conv_final = nn.Conv1d(min(in_ch * 2, max_channels), 1, k2, padding=(k2 - 1) // 2)

    def forward(self, x: torch.Tensor):
        h = F.pad(x.transpose(1, 2), (self.pad0, self.pad0), mode="reflect")
        feats = []
        convs = [self.conv_0] + [getattr(self, f"conv_down_{i}")
                                 for i in range(len(self.downsample_factors))]
        for conv in convs + [self.conv_pre_final]:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            feats.append(h.transpose(1, 2))
        score = self.conv_final(h).transpose(1, 2)
        feats.append(score)
        return score, feats


class MelganMultiscaleDiscriminator(nn.Module):
    """``num_scales`` MelGAN discriminators over the waveform average-pooled
    between scales (port of ``melgan_discriminator.py:71-101``)."""

    def __init__(self, num_scales: int = 3, pooling_kernel_size: int = 4,
                 pooling_stride: int = 2, pooling_padding: int = 2,
                 kernel_sizes: Tuple[int, int] = (5, 3), base_channels: int = 16,
                 max_channels: int = 1024, downsample_factors: Sequence[int] = (4, 4, 4),
                 groups_denominator: int = 4):
        super().__init__()
        self.num_scales = num_scales
        self.pool = (pooling_kernel_size, pooling_stride, pooling_padding)
        for i in range(num_scales):
            self.add_module(f"disc_{i}", MelganDiscriminator(
                tuple(kernel_sizes), base_channels, max_channels, tuple(downsample_factors),
                groups_denominator))

    def forward(self, x: torch.Tensor):
        scores, feats = [], []
        for i in range(self.num_scales):
            if i:
                x = avg_pool(x, *self.pool)
            score, feat = getattr(self, f"disc_{i}")(x)
            scores.append(score)
            feats.append(feat)
        return scores, feats
