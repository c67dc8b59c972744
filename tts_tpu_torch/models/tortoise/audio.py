"""Tortoise's audio front ends in torch, on the model's device (port of
``tts_tpu/models/tortoise/audio.py``, reference
``TTS/tts/layers/tortoise/audio_utils.py`` and
``arch_utils.TorchMelSpectrogram``).

Two mel domains:

* the 80-channel "tacotron" mel at 22.05 kHz (HTK scale, slaney area norm,
  power 2), divided by the per-channel ``mel_norms``: the AR model's
  conditioning input (``arch_utils.py:299``);
* the 100-channel univnet mel at 24 kHz (slaney scale and norm, magnitude):
  the diffusion decoder's conditioning input (``audio_utils.py:161``).

Both take the port's STFT (``audio.torch_transforms.stft_magnitude``, the
JAX package's strided convolution with the windowed DFT basis).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tts_tpu_torch.audio import torch_transforms as tt

# reference audio_utils.py:74-84
TACOTRON_MEL_MAX = 2.3143386840820312
TACOTRON_MEL_MIN = -11.512925148010254


def denormalize_tacotron_mel(norm_mel):
    return ((norm_mel + 1) / 2) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) + TACOTRON_MEL_MIN


def normalize_tacotron_mel(mel):
    return 2 * ((mel - TACOTRON_MEL_MIN) / (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN)) - 1


def tacotron_mel(wav: torch.Tensor, mel_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """22.05 kHz wav ``[B, T]`` → ``[B, T_frames, 80]`` log-mel over
    ``mel_norms`` (torchaudio's defaults in the reference: power 2, HTK
    scale, slaney area norm, centred reflect padding)."""
    mag = tt.stft_magnitude(wav, 1024, 256, 1024, center=True)
    basis = tt.mel_basis(22050, 1024, 80, 0.0, 8000.0, htk=True, norm="slaney",
                         device=wav.device)
    mel = torch.log(torch.clamp(torch.einsum("mk,bkt->bmt", basis, mag**2), min=1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel)[None, :, None]
    return mel.transpose(1, 2)


def wav_to_univnet_mel(wav: torch.Tensor, do_normalization: bool = False) -> torch.Tensor:
    """24 kHz wav ``[B, T]`` → ``[B, T_frames, 100]`` log-mel (reference
    ``audio_utils.py:161``: magnitude, slaney scale)."""
    mag = tt.stft_magnitude(wav, 1024, 256, 1024, center=True, eps=1e-8)
    basis = tt.mel_basis(24000, 1024, 100, 0.0, 12000.0, device=wav.device)
    mel = torch.log(torch.clamp(torch.einsum("mk,bkt->bmt", basis, mag), min=1e-5))
    if do_normalization:
        mel = normalize_tacotron_mel(mel)
    return mel.transpose(1, 2)


def pad_or_truncate(wav: np.ndarray, length: int) -> np.ndarray:
    """``[..., T]`` → ``[..., length]``: zeros appended, or the head kept
    (the reference crops at random; the JAX package and the port keep the
    start)."""
    wav = np.asarray(wav, np.float32)
    t = wav.shape[-1]
    if t < length:
        pad = [(0, 0)] * (wav.ndim - 1) + [(0, length - t)]
        return np.pad(wav, pad)
    return wav[..., :length]


def format_conditioning(clip: np.ndarray, mel_norms: Optional[torch.Tensor] = None,
                        cond_length: int = 132300, device=None) -> torch.Tensor:
    """One 22.05 kHz reference clip ``[T]`` → its conditioning mel ``[1,
    T_frames, 80]`` on ``device`` (reference ``models/tortoise.py:75``)."""
    clip = pad_or_truncate(np.asarray(clip, np.float32).reshape(-1), cond_length)
    return tacotron_mel(torch.from_numpy(clip)[None].to(device), mel_norms=mel_norms)
