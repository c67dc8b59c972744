"""Host-side wav I/O, resampling and the trailing-silence endpoint (port
of part of ``tts_tpu/audio/numpy_transforms.py``: ``load_wav``,
``save_wav``, ``resample_wav``, and ``db_to_amp`` and ``find_endpoint``
copied verbatim with ``_exp``; numpy and scipy only)."""

from __future__ import annotations

import io
from math import gcd
from typing import Tuple

import numpy as np
import scipy.io.wavfile
import scipy.signal


def _read_wav(filename: str) -> Tuple[np.ndarray, int]:
    sr, data = scipy.io.wavfile.read(filename)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # downmix multi-channel
        data = data.mean(axis=1)
    return data, sr


def resample_wav(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if orig_sr == target_sr:
        return wav
    g = gcd(int(orig_sr), int(target_sr))
    return scipy.signal.resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(*, filename: str, sample_rate: int = None, resample: bool = False, **kwargs) -> np.ndarray:
    """Load a wav file as float32, optionally resampling."""
    x, sr = _read_wav(filename)
    if resample and sample_rate is not None and sr != sample_rate:
        x = resample_wav(x, sr, sample_rate)
    return x


def save_wav(*, wav: np.ndarray, path: str, sample_rate: int = None, pipe_out=None, **kwargs) -> None:
    """Save a float waveform as 16-bit PCM, peak-normalized."""
    wav_norm = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wav_norm = wav_norm.astype(np.int16)
    if pipe_out:
        wav_buffer = io.BytesIO()
        scipy.io.wavfile.write(wav_buffer, sample_rate, wav_norm)
        wav_buffer.seek(0)
        pipe_out.buffer.write(wav_buffer.read())
    scipy.io.wavfile.write(path, sample_rate, wav_norm)


def _exp(x, base):
    return np.power(10, x) if base == 10 else np.exp(x)


def db_to_amp(*, x: np.ndarray = None, gain: float = 1, base: int = 10, **kwargs) -> np.ndarray:
    return _exp(x / gain, base)


def find_endpoint(
    *,
    wav: np.ndarray = None,
    trim_db: float = -40,
    sample_rate: int = None,
    min_silence_sec=0.8,
    gain: float = None,
    base: int = None,
    **kwargs,
) -> int:
    window_length = int(sample_rate * min_silence_sec)
    hop_length = int(window_length / 4)
    threshold = db_to_amp(x=-trim_db, gain=gain, base=base)
    for x in range(hop_length, len(wav) - window_length, hop_length):
        if np.max(wav[x : x + window_length]) < threshold:
            return x + hop_length
    return len(wav)
