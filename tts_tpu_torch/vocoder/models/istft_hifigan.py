"""HiFiGAN with an inverse-STFT synthesis head (port of
``tts_tpu/vocoder/models/istft_hifigan.py:29-130``; MB-iSTFT-VITS,
arXiv:2210.15975).

The first upsampling stages are HiFiGAN's; the last ``istft_hop`` samples
per frame (``× subbands`` with the PQMF bank, ``vocoder/layers.py``) come
from an inverse STFT of a predicted (log-magnitude, phase) spectrum: irfft
and overlap-add, plain PyTorch ops. The decoder masks no convolution, so it
does not serve the sequence-packed decode (ROADMAP.md F2).

There is no reference-layout counterpart (the reference ships plain HiFiGAN
only): weights come from the JAX package's parameters
(``utils.convert.vits_from_jax_params``) or from the port's own
``model_torch.pt``. Layout is the JAX package's: ``[B, T, C]`` in,
``[B, T * prod(upsample_factors) * istft_hop * subbands, 1]`` out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import PQMF
from tts_tpu_torch.vocoder.models.hifigan_generator import (
    LRELU_SLOPE,
    ResBlock1,
    ResBlock2,
    _conv1d,
)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """``[B, T, n_fft]`` frames, one every ``hop`` samples, summed into
    ``[B, T * hop + n_fft - hop]``."""
    B, T, n_fft = frames.shape
    y = frames.new_zeros((B, T * hop + n_fft - hop))
    for c in range(n_fft // hop):
        y[:, c * hop : c * hop + T * hop] += frames[:, :, c * hop : (c + 1) * hop].reshape(B, -1)
    return y


def istft_overlap_add(mag: torch.Tensor, phase: torch.Tensor, n_fft: int,
                      hop: int) -> torch.Tensor:
    """``[B, T, n_fft//2+1]`` (linear magnitude, phase in radians) →
    ``[B, T*hop]``: Hann-windowed irfft and overlap-add, divided by the
    window-square envelope, with the half-overlap lead trimmed."""
    if hop > n_fft or n_fft % hop != 0:
        raise ValueError(
            f"istft_overlap_add requires hop <= n_fft and n_fft % hop == 0 "
            f"(got n_fft={n_fft}, hop={hop}); other ratios would drop window "
            f"tail samples from the overlap-add and no longer invert the STFT"
        )
    T = mag.shape[1]
    frames = torch.fft.irfft(torch.polar(mag, phase), n=n_fft, dim=-1)  # [B, T, n_fft]
    win = torch.from_numpy(np.hanning(n_fft + 1)[:n_fft]).to(frames)
    y = _overlap_add(frames * win, hop)
    env = _overlap_add((win * win).expand(1, T, n_fft), hop)
    y = y / torch.clamp(env, min=1e-6)
    lead = (n_fft - hop) // 2
    return y[:, lead : lead + T * hop]


class IstftHifiganGenerator(nn.Module):
    """latents ``[B, T, C_in]`` → waveform ``[B, T * prod(upsample_factors)
    * istft_hop * subbands, 1]``; ``subbands > 1`` predicts one spectrum per
    PQMF band and runs the synthesis filter."""

    def __init__(
        self,
        in_channels: int = 80,
        resblock_type: str = "1",
        resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        upsample_kernel_sizes: Sequence[int] = (16, 16),
        upsample_initial_channel: int = 512,
        upsample_factors: Sequence[int] = (8, 8),
        istft_n_fft: int = 16,
        istft_hop: int = 4,
        subbands: int = 1,
        cond_channels: int = 0,
    ):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.n_fft, self.hop, self.subbands = istft_n_fft, istft_hop, subbands
        self.pqmf = PQMF(N=subbands) if subbands > 1 else None
        resblock_cls = ResBlock1 if str(resblock_type) == "1" else ResBlock2
        ch0 = upsample_initial_channel
        self.conv_pre = _conv1d(in_channels, ch0, 7)
        if cond_channels > 0:
            self.cond_layer = nn.Linear(cond_channels, ch0)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_factors, upsample_kernel_sizes)):
            cin, ch = ch0 // (2**i), ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = _conv1d(ch, 2 * (istft_n_fft // 2 + 1) * subbands, 7)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        o = self.conv_pre(x.transpose(1, 2))  # [B, C, T]
        if hasattr(self, "cond_layer") and g is not None:
            if g.dim() == 2:
                g = g[:, None, :]
            o = o + self.cond_layer(g).transpose(1, 2)
        for i, up in enumerate(self.ups):
            o = up(F.leaky_relu(o, LRELU_SLOPE))
            z_sum = None
            for j in range(self.num_kernels):
                z = self.resblocks[i * self.num_kernels + j](o)
                z_sum = z if z_sum is None else z_sum + z
            o = z_sum / self.num_kernels
        spec = self.conv_post(F.leaky_relu(o, 0.01)).transpose(1, 2)  # [B, T, 2*F*S]
        B, T, _ = spec.shape
        n_bins, S = self.n_fft // 2 + 1, self.subbands
        spec = spec.reshape(B, T, S, 2 * n_bins)
        # the log-magnitude clipped, the phase bounded (the paper's choice)
        mag = torch.exp(torch.clamp(spec[..., :n_bins], -12.0, 8.0))
        phase = math.pi * torch.sin(spec[..., n_bins:])
        # every band's iSTFT at once: the bands folded into the batch
        mag = mag.transpose(1, 2).reshape(B * S, T, n_bins)
        phase = phase.transpose(1, 2).reshape(B * S, T, n_bins)
        wav = istft_overlap_add(mag, phase, self.n_fft, self.hop).reshape(B, S, -1)
        if S == 1:
            return torch.tanh(wav.transpose(1, 2))  # [B, T*hop, 1]
        return torch.tanh(self.pqmf.synthesis(wav.transpose(1, 2)))  # [B, T*hop*S, 1]
