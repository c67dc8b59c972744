"""On-device audio transforms in PyTorch (port of
``tts_tpu/audio/jax_transforms.py``: ``stft_real_imag``, ``stft_magnitude``,
``wav_to_spec``, ``spectral_norm_log``, ``spec_to_mel``, ``wav_to_mel``,
``amp_to_db`` and ``db_to_amp``).

The STFT is the same strided convolution with the windowed DFT basis that
the JAX package uses (``stft_basis``), so both packages compute the same
sums; against JAX on the CPU they agree to float32 rounding (the tests hold
them to 1e-4 relative on log-mel). Layouts follow the JAX functions:
``[B, T]`` wavs in, ``[B, K, frames]`` spectra and ``[B, M, frames]`` mels out.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from .mel import mel_filterbank


@functools.lru_cache(maxsize=16)
def stft_basis(fft_size: int, win_length: int, window: str = "hann") -> np.ndarray:
    """Windowed DFT basis as a conv kernel ``[2*(fft_size//2+1), 1, fft_size]``:
    cos rows, then -sin rows, times the periodic analysis window."""
    n_bins = fft_size // 2 + 1
    w = scipy.signal.get_window(window, win_length, fftbins=True)
    lpad = (fft_size - win_length) // 2
    w = np.pad(w, (lpad, fft_size - win_length - lpad))
    n = np.arange(fft_size)
    k = np.arange(n_bins)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / fft_size
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * w[None, :]
    return basis.astype(np.float32)[:, None, :]


def stft_real_imag(
    y: torch.Tensor,  # [B, T] or [T]
    fft_size: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    pad_wav: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The STFT as one strided convolution with the windowed DFT basis:
    ``(real, imag)``, each ``[B, K, n_frames]`` (``[K, n_frames]`` for 1-D
    input), ``K = fft_size // 2 + 1``. ``center`` pads ``fft_size // 2`` on
    each side, ``pad_wav`` (VITS) ``(fft_size - hop) // 2``; ``pad_mode``
    ``reflect`` or zeros."""
    squeeze = y.dim() == 1
    if squeeze:
        y = y[None]
    y = y.float()
    if center:
        p = fft_size // 2
    elif pad_wav:  # VITS-style (n_fft - hop) / 2 on both sides
        p = (fft_size - hop_length) // 2
    else:
        p = 0
    if p:
        y = F.pad(y[:, None], (p, p), mode="reflect" if pad_mode == "reflect" else "constant")[:, 0]
    kernel = torch.from_numpy(stft_basis(fft_size, win_length, window)).to(y.device, y.dtype)
    out = F.conv1d(y[:, None, :], kernel, stride=hop_length)  # [B, 2K, frames]
    n_bins = fft_size // 2 + 1
    re, im = out[:, :n_bins], out[:, n_bins:]
    return (re[0], im[0]) if squeeze else (re, im)


def stft_magnitude(
    y: torch.Tensor,  # [B, T] or [T]
    fft_size: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    pad_wav: bool = False,
    eps: float = 1e-9,
) -> torch.Tensor:
    """``sqrt(re² + im² + eps)`` → ``[B, K, n_frames]`` (``[K, n_frames]`` for 1-D input)."""
    re, im = stft_real_imag(y, fft_size, hop_length, win_length, window, center, pad_mode,
                            pad_wav)
    return torch.sqrt(re * re + im * im + eps)


def wav_to_spec(
    y: torch.Tensor, n_fft: int, hop_length: int, win_length: int, center: bool = False
) -> torch.Tensor:
    """VITS-convention linear magnitude spectrogram ``[B, K, T]``."""
    return stft_magnitude(
        y, n_fft, hop_length, win_length, center=center, pad_wav=not center, eps=1e-6
    )


@functools.lru_cache(maxsize=16)
def _mel_basis_np(sample_rate, n_fft, num_mels, fmin, fmax, htk=False, norm="slaney"):
    return mel_filterbank(sample_rate, n_fft, num_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm)


def mel_basis(sample_rate, n_fft, num_mels, fmin=0.0, fmax=None, htk=False, norm="slaney",
              device=None) -> torch.Tensor:
    """``[num_mels, n_fft//2+1]`` filterbank as a float32 tensor."""
    return torch.from_numpy(_mel_basis_np(sample_rate, n_fft, num_mels, fmin, fmax, htk, norm)).to(device)


def spectral_norm_log(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """Dynamic-range compression ``log(clamp(x, clip_val))`` (reference ``vits.py:74``)."""
    return torch.log(torch.clamp(x, min=clip_val))


def spec_to_mel(
    spec: torch.Tensor, n_fft: int, num_mels: int, sample_rate: int, fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> torch.Tensor:
    """Linear spectrogram ``[B, K, T]`` → log-mel ``[B, M, T]`` (log of clamp at 1e-5)."""
    spec = spec.float()
    basis = mel_basis(sample_rate, n_fft, num_mels, fmin, fmax, device=spec.device).to(spec.dtype)
    mel = torch.einsum("mk,bkt->bmt", basis, spec)
    return spectral_norm_log(mel)


def wav_to_mel(
    y: torch.Tensor,
    n_fft: int,
    num_mels: int,
    sample_rate: int,
    hop_length: int,
    win_length: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    center: bool = False,
) -> torch.Tensor:
    """wav ``[B, T]`` → log-mel ``[B, M, frames]``."""
    spec = wav_to_spec(y, n_fft, hop_length, win_length, center=center)
    return spec_to_mel(spec, n_fft, num_mels, sample_rate, fmin, fmax)


def amp_to_db(x: torch.Tensor, gain: float = 1.0, base: float = 10.0) -> torch.Tensor:
    """``gain * log_base(max(x, 1e-8))``, base 10 or e."""
    x = torch.clamp(x, min=1e-8)
    return gain * (torch.log10(x) if base == 10 else torch.log(x))


def db_to_amp(x: torch.Tensor, gain: float = 1.0, base: float = 10.0) -> torch.Tensor:
    """The inverse of :func:`amp_to_db`: ``base ** (x / gain)``."""
    return torch.pow(10.0, x / gain) if base == 10 else torch.exp(x / gain)
