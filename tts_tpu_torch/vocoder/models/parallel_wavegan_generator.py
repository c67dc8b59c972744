"""Parallel WaveGAN generator (port of
``tts_tpu/vocoder/models/parallel_wavegan_generator.py:19-132``, reference
``TTS/vocoder/models/parallel_wavegan_generator.py`` and
``layers/parallel_wavegan.py``): ``PWGANResidualBlock``, ``ConvUpsample``
and ``ParallelWaveganGenerator``, inference only. A non-causal WaveNet over
noise, conditioned on the mel upsampled to the sample rate.

Public layout is the JAX package's: mel ``[B, T, M]`` and noise
``[B, T * prod(upsample_factors), in_channels]`` in, ``[B, T', C_out]`` out;
the network runs on ``[B, C, T]`` inside, its flax ``Dense`` layers as 1x1
convolutions. Module and parameter names follow the flax modules', so
``utils.convert.flax_to_state_dict`` maps the JAX parameters one to one; the
upsampling's smoothing taps keep the JAX shape ``(2f + 1, 1, 1)``.

``inference(c)`` settles ROADMAP.md F31: the JAX module has no
``inference``, so the JAX ``Synthesizer`` raises on this vocoder. Here it
pads the mel by ``inference_padding`` edge frames on each side, as the JAX
HiFiGAN and MelGAN ``inference`` methods do, and draws the input noise from
an explicit ``torch.Generator``; ``forward(c, x)`` takes the noise as given.
The discriminator serves training and waits for it (ROADMAP.md item 17).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import noise_generator, pointwise, shared_tap_upsample


class PWGANResidualBlock(nn.Module):
    """Dilated conv → gated tanh·sigmoid with the mel added to both halves →
    skip and residual 1x1 outputs; ``[B, C, T]`` in and out."""

    def __init__(self, res_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv1d(res_channels, gate_channels, kernel_size, dilation=dilation,
                              padding=pad)
        self.conv1x1_aux = nn.Linear(aux_channels, gate_channels, bias=False)
        self.conv1x1_skip = nn.Linear(gate_channels // 2, skip_channels)
        self.conv1x1_out = nn.Linear(gate_channels // 2, res_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        xa, xb = (self.conv(x) + pointwise(self.conv1x1_aux, c)).chunk(2, dim=1)
        h = torch.tanh(xa) * torch.sigmoid(xb)
        return (pointwise(self.conv1x1_out, h) + x) * (0.5**2), pointwise(self.conv1x1_skip, h)


class ConvUpsample(nn.Module):
    """A bias-free 1x1 conv (the JAX module's ``aux_context_window`` of 0,
    the only value its generator gives), then per factor ``f`` a nearest
    repeat and one ``2f + 1`` smoothing tap shared across channels
    (``up_<i>``, ``(2f + 1, 1, 1)``); ``[B, C, T]`` in and out."""

    def __init__(self, channels: int, upsample_factors: Sequence[int]):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.conv_in = nn.Conv1d(channels, channels, 1, bias=False)
        for i, f in enumerate(self.upsample_factors):
            k = 2 * f + 1
            self.register_parameter(f"up_{i}", nn.Parameter(torch.full((k, 1, 1), 1.0 / k)))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.conv_in(c)
        for i, f in enumerate(self.upsample_factors):
            c = shared_tap_upsample(c, getattr(self, f"up_{i}"), f)
        return c


class ParallelWaveganGenerator(nn.Module):
    """Noise ``[B, T_wav, in_channels]`` and mel ``[B, T, aux_channels]`` →
    waveform ``[B, T_wav, out_channels]``, ``T_wav = T * prod(upsample_factors)``:
    ``num_res_blocks`` residual blocks in ``stacks`` dilation cycles, their
    skips summed and scaled by ``sqrt(1 / num_res_blocks)``, then ReLU, 1x1,
    ReLU, 1x1."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 num_res_blocks: int = 30, stacks: int = 3, res_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 upsample_factors: Sequence[int] = (4, 4, 4, 4), inference_padding: int = 2):
        super().__init__()
        self.in_channels = in_channels
        self.num_res_blocks = num_res_blocks
        self.inference_padding = inference_padding
        self.upsample_factors = tuple(upsample_factors)
        self.hop = math.prod(self.upsample_factors)
        self.upsample_net = ConvUpsample(aux_channels, self.upsample_factors)
        self.first_conv = nn.Linear(in_channels, res_channels)
        layers_per_stack = num_res_blocks // stacks
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", PWGANResidualBlock(
                res_channels, gate_channels, skip_channels, aux_channels, kernel_size,
                dilation=2 ** (i % layers_per_stack)))
        self.last_conv_1 = nn.Linear(skip_channels, skip_channels)
        self.last_conv_2 = nn.Linear(skip_channels, out_channels)

    def forward(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        c_up = self.upsample_net(c.transpose(1, 2))[:, :, : x.shape[1]]
        h = pointwise(self.first_conv, x.transpose(1, 2))
        skips = 0.0
        for i in range(self.num_res_blocks):
            h, s = getattr(self, f"res_{i}")(h, c_up)
            skips = skips + s
        o = F.relu(skips * math.sqrt(1.0 / self.num_res_blocks))
        o = F.relu(pointwise(self.last_conv_1, o))
        return pointwise(self.last_conv_2, o).transpose(1, 2)

    def noise(self, c: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Standard normal input noise for the mel ``c`` ``[B, T, M]``, drawn
        from ``generator`` (on its device) and moved to ``c``'s."""
        g = generator or noise_generator(c.device)
        shape = (c.shape[0], c.shape[1] * self.hop, self.in_channels)
        return torch.randn(shape, generator=g, device=g.device, dtype=c.dtype).to(c.device)

    def inference(self, c: torch.Tensor, generator: Optional[torch.Generator] = None,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mel with ``inference_padding`` edge frames on each side, over
        noise ``x`` (drawn from ``generator`` when not given)."""
        p = self.inference_padding
        c = F.pad(c.transpose(1, 2), (p, p), mode="replicate").transpose(1, 2)
        return self(c, self.noise(c, generator) if x is None else x)
