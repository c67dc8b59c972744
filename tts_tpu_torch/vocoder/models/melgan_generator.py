"""MelGAN generator family (port of ``tts_tpu/vocoder/models/melgan_generator.py:21-165``,
reference ``TTS/vocoder/models/melgan_generator.py``,
``fullband_melgan_generator.py`` and ``multiband_melgan_generator.py``):
``ResidualStack``, ``MelganGenerator``, ``FullbandMelganGenerator`` and
``MultibandMelganGenerator``.

Public layout is the JAX package's: mel ``[B, T, C]`` in, ``[B, T', C_out]``
out; the convolutions run on ``[B, C, T]`` inside. Upsampling is
``nn.ConvTranspose1d`` itself, with the JAX package's stride, padding and
output padding; the JAX ``TorchConvTranspose1d`` exists only to reproduce
it, and ``utils.convert`` flips its time-reversed kernel back.
``inference`` pads the mel by repeating its two edge frames on each side
(``inference_padding``); the multi-band generator then merges its four
bands with the pseudo-QMF synthesis filter (``vocoder.layers.PQMF``).
Training (``vocoder/models/gan.py``) runs ``forward`` on the mel as it is.
Module and parameter names follow the flax modules', so
``utils.convert.flax_to_state_dict`` maps the JAX parameters one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import PQMF

LRELU_SLOPE = 0.2


class ResidualStack(nn.Module):
    """Dilated residual stack: block ``j`` is leaky ReLU → reflect pad →
    conv (dilation ``kernel_size ** j``) → leaky ReLU → 1x1 conv, added to a
    1x1 shortcut of its input. ``[B, C, T]`` in and out."""

    def __init__(self, channels: int, num_res_blocks: int, kernel_size: int):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.kernel_size = kernel_size
        for j in range(num_res_blocks):
            self.add_module(f"block{j}_conv1", nn.Conv1d(channels, channels, kernel_size,
                                                         dilation=kernel_size**j))
            self.add_module(f"block{j}_conv2", nn.Conv1d(channels, channels, 1))
            self.add_module(f"shortcut{j}", nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base_padding = (self.kernel_size - 1) // 2
        for j in range(self.num_res_blocks):
            padding = base_padding * self.kernel_size**j
            y = F.pad(F.leaky_relu(x, LRELU_SLOPE), (padding, padding), mode="reflect")
            y = getattr(self, f"block{j}_conv1")(y)
            y = getattr(self, f"block{j}_conv2")(F.leaky_relu(y, LRELU_SLOPE))
            x = getattr(self, f"shortcut{j}")(x) + y
        return x


class MelganGenerator(nn.Module):
    """MelGAN: reflect-padded projection, then per upsampling factor ``u``
    a leaky ReLU, a transposed conv (kernel ``2u``, stride ``u``, halving the
    channels) and a residual stack, then the output projection and tanh."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1, proj_kernel: int = 7,
                 base_channels: int = 512, upsample_factors: Sequence[int] = (8, 8, 2, 2),
                 res_kernel: int = 3, num_res_blocks: int = 3, inference_padding: int = 2):
        super().__init__()
        self.proj_kernel = proj_kernel
        self.out_channels = out_channels
        self.inference_padding = inference_padding
        self.upsample_factors = tuple(upsample_factors)
        self.conv_pre = nn.Conv1d(in_channels, base_channels, proj_kernel)
        self.ups = nn.ModuleList()
        ch = base_channels
        for i, u in enumerate(self.upsample_factors):
            out_ch = base_channels // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, out_ch, u * 2, stride=u,
                                               padding=u // 2 + u % 2, output_padding=u % 2))
            self.add_module(f"res_{i}", ResidualStack(out_ch, num_res_blocks, res_kernel))
            ch = out_ch
        self.conv_post = nn.Conv1d(ch, out_channels, proj_kernel)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """``[B, T, C_in]`` → ``[B, T * prod(upsample_factors), C_out]``."""
        pad = (self.proj_kernel - 1) // 2
        x = self.conv_pre(F.pad(c.transpose(1, 2), (pad, pad), mode="reflect"))
        for i, up in enumerate(self.ups):
            x = getattr(self, f"res_{i}")(up(F.leaky_relu(x, LRELU_SLOPE)))
        x = F.pad(F.leaky_relu(x, LRELU_SLOPE), (pad, pad), mode="reflect")
        return torch.tanh(self.conv_post(x)).transpose(1, 2)

    def _pad_edges(self, c: torch.Tensor) -> torch.Tensor:
        p = self.inference_padding
        return F.pad(c.transpose(1, 2), (p, p), mode="replicate").transpose(1, 2)

    def inference(self, c: torch.Tensor) -> torch.Tensor:
        """The mel with ``inference_padding`` edge frames on each side."""
        return self(self._pad_edges(c))


class FullbandMelganGenerator(MelganGenerator):
    """The same network with 4 blocks in each residual stack."""

    def __init__(self, num_res_blocks: int = 4, **kwargs):
        super().__init__(num_res_blocks=num_res_blocks, **kwargs)


class MultibandMelganGenerator(MelganGenerator):
    """Four sub-bands from a narrower MelGAN; ``forward`` emits the bands
    ``[B, T', 4]``, ``inference`` merges them into ``[B, 4 T', 1]``."""

    def __init__(self, out_channels: int = 4, base_channels: int = 384,
                 upsample_factors: Sequence[int] = (2, 8, 2, 2), **kwargs):
        super().__init__(out_channels=out_channels, base_channels=base_channels,
                         upsample_factors=upsample_factors, **kwargs)
        self.pqmf = PQMF(N=out_channels)

    def pqmf_synthesis(self, x: torch.Tensor) -> torch.Tensor:
        return self.pqmf.synthesis(x)

    def inference(self, c: torch.Tensor) -> torch.Tensor:
        return self.pqmf.synthesis(self(self._pad_edges(c)))
