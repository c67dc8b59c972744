"""Vocoder layers of the port: the pseudo-QMF filter bank (port of
``PQMF`` and ``pqmf_filters`` in ``tts_tpu/vocoder/models/melgan_generator.py:93-142``,
reference ``TTS/vocoder/layers/pqmf.py``), and what ParallelWaveGAN,
UnivNet, WaveGrad and WaveRNN share: the 1x1 convolution of a flax ``Dense``
on ``[B, C, T]``, the nearest-repeat upsampling with one smoothing tap shared
across channels, the default noise generator, and the random weights a
vocoder starts training from (:func:`init_weights`).

The synthesis side serves the multi-band iSTFT decoder
(``istft_subbands_decoder > 1``) and the multi-band MelGAN generator; the
analysis side splits the real waveform into its bands for the sub-band
STFT loss of multi-band MelGAN training (``vocoder/models/gan.py``). The
filters are designed on the host in float64 (``scipy.signal.firwin``) and
cast to float32, as in the JAX package; each filter moves to the signal's
device and dtype at its first call there and stays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def pointwise(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (a flax ``Dense`` carried as ``nn.Linear``) on every time
    step of ``[B, C_in, T]`` → ``[B, C_out, T]``, as a 1x1 convolution."""
    return F.conv1d(x, layer.weight[..., None], layer.bias)


def shared_tap_upsample(x: torch.Tensor, tap: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C, T]`` → ``[B, C, T * factor]``: each frame repeated
    ``factor`` times, then smoothed by one ``(2 factor + 1)``-tap kernel
    shared by every channel (``tap`` of any shape with that many elements),
    zero padding ``factor`` on each side. The reference stores the tap as a
    ``Conv2d(1, 1, (1, k))`` over the (C, T) plane; the JAX package as a
    depthwise kernel broadcast over channels."""
    B, C, T = x.shape
    x = torch.repeat_interleave(x, factor, dim=2).reshape(B * C, 1, T * factor)
    return F.conv1d(x, tap.reshape(1, 1, -1), padding=factor).reshape(B, C, T * factor)


def noise_generator(device, seed: int = 0) -> torch.Generator:
    """The generator a vocoder draws from when the caller passes none: on
    ``device``, seeded with ``seed`` (so each call draws the same noise, as
    the JAX package's ``PRNGKey(0)`` does; the draws themselves differ from
    ``jax.random``'s, and between devices)."""
    return torch.Generator(device=device).manual_seed(seed)


def pqmf_filters(N: int = 4, taps: int = 62, cutoff: float = 0.15,
                 beta: float = 9.0) -> Tuple[np.ndarray, np.ndarray]:
    """Kaiser-window QMF analysis and synthesis banks ``(H, G)``, each
    ``[N, taps + 1]`` float32."""
    from scipy import signal as sig

    qmf = sig.firwin(taps + 1, cutoff, window=("kaiser", beta))
    H = np.zeros((N, taps + 1))
    G = np.zeros((N, taps + 1))
    for k in range(N):
        factor = (2 * k + 1) * (np.pi / (2 * N)) * (np.arange(taps + 1) - ((taps - 1) / 2))
        phase = (-1) ** k * np.pi / 4
        H[k] = 2 * qmf * np.cos(factor + phase)
        G[k] = 2 * qmf * np.cos(factor - phase)
    return H.astype(np.float32), G.astype(np.float32)


class PQMF:
    """Pseudo-QMF multi-band analysis and synthesis on ``[B, T, C]``
    tensors; stateless apart from the filters."""

    def __init__(self, N: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
        self.N = N
        self.taps = taps
        H, G = pqmf_filters(N, taps, cutoff, beta)
        self.H = torch.from_numpy(H)[:, None]  # conv1d weight [N, 1, taps + 1]
        self.G = torch.from_numpy(G)[None]  # conv1d weight [1, N, taps + 1]

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, 1]`` → ``[B, T // N, N]``: the analysis filter of each
        band, then every ``N``-th sample (a stride-``N`` convolution, zero
        padding ``taps // 2`` on each side)."""
        if self.H.device != x.device or self.H.dtype != x.dtype:
            self.H = self.H.to(x)
        return F.conv1d(x.transpose(1, 2), self.H, stride=self.N,
                        padding=self.taps // 2).transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T // N, N]`` → ``[B, T, 1]``: each band upsampled by ``N``
        (zero-stuffed and scaled by ``N``), then the synthesis filter."""
        B, T, N = x.shape
        up = x.new_zeros((B, N, T * N))
        up[:, :, :: N] = x.transpose(1, 2) * N
        if self.G.device != x.device or self.G.dtype != x.dtype:
            self.G = self.G.to(x)
        return F.conv1d(up, self.G, padding=self.taps // 2).transpose(1, 2)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 zero: Tuple[str, ...] = ()) -> nn.Module:
    """Random fp32 weights for ``module`` from ``generator`` (on the CPU, so
    the draw is the same on every machine), in the order of its
    parameters, as flax's default initialisers set them: a bias 0, a norm's
    scale 1 and shift 0, a shared smoothing tap ``(2f + 1, 1, 1)`` the mean
    ``1 / (2f + 1)``, every other weight N(0, 1 / fan_in) (fan_in: a
    transposed convolution's ``in x k``, else the elements a row of the
    weight holds). Parameters whose names end with a suffix in ``zero``
    are 0 (WaveGrad's head, which the JAX module zero-initialises)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if name.endswith(zero) and zero:
            p.zero_()
        elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)) or leaf.endswith("_scale"):
            p.fill_(1.0 if leaf == "weight" or leaf.endswith("_scale") else 0.0)
        elif leaf.startswith("bias") or leaf.endswith("_shift"):
            p.zero_()
        elif p.dim() == 3 and p.shape[1:] == (1, 1) and leaf.startswith("up_"):
            p.fill_(1.0 / p.shape[0])
        else:
            fan_in = p.shape[0] * p.shape[2] if isinstance(owner, nn.ConvTranspose1d) else \
                p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) / fan_in**0.5)
    return module
