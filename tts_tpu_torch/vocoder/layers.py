"""Vocoder layers of the port: the pseudo-QMF filter bank (port of
``PQMF`` and ``pqmf_filters`` in ``tts_tpu/vocoder/models/melgan_generator.py:93-142``,
reference ``TTS/vocoder/layers/pqmf.py``).

The synthesis side serves the multi-band iSTFT decoder
(``istft_subbands_decoder > 1``) and the multi-band MelGAN generator; the
analysis side serves training and waits for it (ROADMAP.md item 17). The
filters are designed on the host in float64 (``scipy.signal.firwin``) and
cast to float32, as in the JAX package; the synthesis filter moves to the
signal's device and dtype at its first call there and stays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
    """Pseudo-QMF multi-band synthesis on ``[B, T, C]`` tensors; stateless
    apart from the filters. The analysis side serves training and the
    MelGAN family, and waits for them."""

    def __init__(self, N: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
        self.N = N
        self.taps = taps
        _, G = pqmf_filters(N, taps, cutoff, beta)
        self.G = torch.from_numpy(G)[None]  # conv1d weight [1, N, taps + 1]

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T // N, N]`` → ``[B, T, 1]``: each band upsampled by ``N``
        (zero-stuffed and scaled by ``N``), then the synthesis filter."""
        B, T, N = x.shape
        up = x.new_zeros((B, N, T * N))
        up[:, :, :: N] = x.transpose(1, 2) * N
        if self.G.device != x.device or self.G.dtype != x.dtype:
            self.G = self.G.to(x)
        return F.conv1d(up, self.G, padding=self.taps // 2).transpose(1, 2)
