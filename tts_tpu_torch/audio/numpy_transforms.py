"""Host-side audio ops, numpy and scipy only (port of
``tts_tpu/audio/numpy_transforms.py``, copied unchanged apart from what the
port does not run yet): the librosa-compatible centred ``stft``/``istft``,
``griffin_lim``, mel ↔ linear (``spec_to_mel``, ``mel_to_spec``), decibels
(``amp_to_db``, ``db_to_amp``), the preemphasis pair, the trailing-silence
endpoint (``find_endpoint``), the leading and trailing silence trim
(``trim_silence``), the volume norms, and wav I/O with resampling.

``griffin_lim`` draws its first phases from numpy's global generator, as
its source does: seed ``np.random`` before a call to repeat it. f0 (YIN)
and energy serve the training dataset's feature caches; the mu-law and
bit-depth codecs serve the vocoders' datasets and wait for them.
"""

from __future__ import annotations

import io
from math import gcd
from typing import Tuple

import numpy as np
import scipy.io.wavfile
import scipy.signal

from .mel import build_mel_basis  # noqa: F401  (re-exported, as in the source)

# --------------------------------------------------------------------------
# framing / windows
# --------------------------------------------------------------------------


def _get_window(window: str, win_length: int) -> np.ndarray:
    return scipy.signal.get_window(window, win_length, fftbins=True)


def _pad_center(w: np.ndarray, size: int) -> np.ndarray:
    n = len(w)
    lpad = (size - n) // 2
    return np.pad(w, (lpad, size - n - lpad))


def _frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping columns ``[frame_length, n_frames]``."""
    n_frames = 1 + (len(x) - frame_length) // hop_length
    strides = (x.strides[0], hop_length * x.strides[0])
    return np.lib.stride_tricks.as_strided(x, shape=(frame_length, n_frames), strides=strides)


def millisec_to_length(
    *, frame_length_ms: int = None, frame_shift_ms: int = None, sample_rate: int = None, **kwargs
) -> Tuple[int, int]:
    """``(win_length, hop_length)`` from milliseconds."""
    factor = frame_length_ms / frame_shift_ms
    assert factor.is_integer(), " [!] frame_shift_ms should divide frame_length_ms"
    win_length = int(frame_length_ms / 1000.0 * sample_rate)
    hop_length = int(win_length / float(factor))
    return win_length, hop_length


# --------------------------------------------------------------------------
# dB / scaling
# --------------------------------------------------------------------------


def _log(x, base):
    return np.log10(x) if base == 10 else np.log(x)


def _exp(x, base):
    return np.power(10, x) if base == 10 else np.exp(x)


def amp_to_db(*, x: np.ndarray = None, gain: float = 1, base: int = 10, **kwargs) -> np.ndarray:
    assert (x < 0).sum() == 0, " [!] Input values must be non-negative."
    return gain * _log(np.maximum(1e-8, x), base)


def db_to_amp(*, x: np.ndarray = None, gain: float = 1, base: int = 10, **kwargs) -> np.ndarray:
    return _exp(x / gain, base)


def preemphasis(*, x: np.ndarray, coef: float = 0.97, **kwargs) -> np.ndarray:
    if coef == 0:
        raise RuntimeError(" [!] Preemphasis is set 0.0.")
    return scipy.signal.lfilter([1, -coef], [1], x)


def deemphasis(*, x: np.ndarray = None, coef: float = 0.97, **kwargs) -> np.ndarray:
    if coef == 0:
        raise RuntimeError(" [!] Preemphasis is set 0.0.")
    return scipy.signal.lfilter([1], [1, -coef], x)


# --------------------------------------------------------------------------
# spectrograms
# --------------------------------------------------------------------------


def spec_to_mel(*, spec: np.ndarray, mel_basis: np.ndarray = None, **kwargs) -> np.ndarray:
    """``[C, T] -> [M, T]``"""
    return np.dot(mel_basis, spec)


def mel_to_spec(*, mel: np.ndarray = None, mel_basis: np.ndarray = None, **kwargs) -> np.ndarray:
    assert (mel < 0).sum() == 0, " [!] Input values must be non-negative."
    inv_mel_basis = np.linalg.pinv(mel_basis)
    return np.maximum(1e-10, np.dot(inv_mel_basis, mel))


def stft(
    *,
    y: np.ndarray = None,
    fft_size: int = None,
    hop_length: int = None,
    win_length: int = None,
    pad_mode: str = "reflect",
    window: str = "hann",
    center: bool = True,
    **kwargs,
) -> np.ndarray:
    """Centered STFT, librosa-compatible. Returns complex ``[1+fft_size//2, T]``."""
    if win_length is None:
        win_length = fft_size
    if hop_length is None:
        hop_length = win_length // 4
    w = _pad_center(_get_window(window, win_length), fft_size)
    if center:
        y = np.pad(y, fft_size // 2, mode=pad_mode)
    frames = _frame(y, fft_size, hop_length)
    return np.fft.rfft(frames * w[:, None], axis=0)


def istft(
    *,
    y: np.ndarray = None,
    hop_length: int = None,
    win_length: int = None,
    window: str = "hann",
    center: bool = True,
    **kwargs,
) -> np.ndarray:
    """Inverse STFT with NOLA window-sum correction (librosa-compatible)."""
    n_fft = 2 * (y.shape[0] - 1)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    w = _pad_center(_get_window(window, win_length), n_fft)
    n_frames = y.shape[1]
    expected_len = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(expected_len)
    win_sum = np.zeros(expected_len)
    frames = np.fft.irfft(y, n=n_fft, axis=0)
    wsq = w**2
    for i in range(n_frames):
        s = i * hop_length
        out[s : s + n_fft] += frames[:, i] * w
        win_sum[s : s + n_fft] += wsq
    out = out / np.maximum(win_sum, 1e-10)
    if center:
        out = out[n_fft // 2 : expected_len - n_fft // 2]
    return out


def griffin_lim(*, spec: np.ndarray = None, num_iter=60, **kwargs) -> np.ndarray:
    """Griffin-Lim phase reconstruction; the first phases are drawn from
    numpy's global generator."""
    angles = np.exp(2j * np.pi * np.random.rand(*spec.shape))
    S_complex = np.abs(spec).astype(complex)
    y = istft(y=S_complex * angles, **kwargs)
    if not np.isfinite(y).all():
        print(" [!] Waveform is not finite everywhere. Skipping the GL.")
        return np.array([0.0])
    for _ in range(num_iter):
        angles = np.exp(1j * np.angle(stft(y=y, **kwargs)))
        y = istft(y=S_complex * angles, **kwargs)
    return y


def compute_f0(
    *,
    x: np.ndarray = None,
    pitch_fmax: float = None,
    pitch_fmin: float = None,
    hop_length: int = None,
    win_length: int = None,
    sample_rate: int = None,
    stft_pad_mode: str = "reflect",
    center: bool = True,
    threshold: float = 0.1,
    **kwargs,
) -> np.ndarray:
    """Frame-wise f0 via YIN. Unvoiced frames are set to 0 (matching the
    reference's pyin post-processing, ``numpy_transforms.py:299-301``).

    Returns shape ``[T_frames]`` aligned with the mel frames (same hop)."""
    assert pitch_fmax is not None, " [!] Set `pitch_fmax` before calling `compute_f0`."
    assert pitch_fmin is not None, " [!] Set `pitch_fmin` before calling `compute_f0`."
    frame_length = win_length
    x = x.astype(np.float64)
    if center:
        x = np.pad(x, frame_length // 2, mode=stft_pad_mode)
    frames = _frame(x, frame_length, hop_length).T.copy()  # [n_frames, frame_length]
    n_frames = frames.shape[0]

    tau_min = max(1, int(sample_rate / pitch_fmax))
    tau_max = min(frame_length - 1, int(sample_rate / max(pitch_fmin, 1e-6)))

    # difference function d(tau) via FFT autocorrelation:
    #   d(tau) = r(0) + r_tau-shifted energy - 2*acf(tau)
    w = frame_length
    fsize = int(2 ** np.ceil(np.log2(2 * w)))
    fft = np.fft.rfft(frames, fsize, axis=1)
    acf = np.fft.irfft(fft * np.conj(fft), fsize, axis=1)[:, : tau_max + 1]
    # cumulative energy terms
    sq = frames**2
    # energy of x[tau:w] for each tau: e(tau) = sum_{j=tau}^{w-1} x_j^2
    cum = np.concatenate([np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)], axis=1)
    total = cum[:, w : w + 1]
    e_tail = total - cum[:, : tau_max + 1]  # energy of x[tau:]
    e_head = cum[:, w - np.arange(tau_max + 1)]  # energy of x[0 : w - tau]
    d = e_head + e_tail - 2 * acf
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    tau_range = np.arange(1, tau_max + 1)
    cumsum_d = np.cumsum(d[:, 1:], axis=1)
    cmnd = d[:, 1:] * tau_range / np.maximum(cumsum_d, 1e-12)
    # classic YIN: when there is no signal energy, CMND is defined as 1
    cmnd[cumsum_d < 1e-10] = 1.0
    cmnd = np.concatenate([np.ones((n_frames, 1)), cmnd], axis=1)  # cmnd[0] = 1

    f0 = np.zeros(n_frames)
    below = cmnd < threshold
    below[:, :tau_min] = False
    for i in range(n_frames):
        idx = np.nonzero(below[i])[0]
        if len(idx) == 0:
            # unvoiced: reference pyin writes 0
            continue
        # first run below threshold → local min within it
        tau = idx[0]
        while tau + 1 <= tau_max and cmnd[i, tau + 1] < cmnd[i, tau]:
            tau += 1
        # parabolic interpolation around tau
        if 0 < tau < tau_max:
            a, b, c = d[i, tau - 1], d[i, tau], d[i, tau + 1]
            denom = a + c - 2 * b
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            shift = np.clip(shift, -1, 1)
        else:
            shift = 0.0
        f0[i] = sample_rate / (tau + shift)
    return f0


def compute_energy(y: np.ndarray, **kwargs) -> np.ndarray:
    """Frame-wise magnitude energy (reference ``numpy_transforms.py:306``)."""
    x = stft(y=y, **kwargs)
    mag = np.abs(x)
    return np.sqrt(np.sum(mag**2, axis=0))


# --------------------------------------------------------------------------
# silence / volume
# --------------------------------------------------------------------------


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


def _rms_frames(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    y = np.pad(y, frame_length // 2, mode="constant")
    frames = _frame(y, frame_length, hop_length)
    return np.sqrt(np.mean(frames**2, axis=0))


def trim_silence(
    *,
    wav: np.ndarray = None,
    sample_rate: int = None,
    trim_db: float = None,
    win_length: int = None,
    hop_length: int = None,
    **kwargs,
) -> np.ndarray:
    """Trim leading and trailing silence below ``trim_db`` relative to the
    peak RMS, after cutting a 0.01 s margin off each end
    (``librosa.effects.trim``-equivalent)."""
    margin = int(sample_rate * 0.01)
    wav = wav[margin:-margin] if margin > 0 else wav
    rms = _rms_frames(wav.astype(np.float64), win_length, hop_length)
    power = rms**2
    ref = power.max()
    if ref <= 0:
        return wav
    db = 10.0 * np.log10(np.maximum(power, 1e-20) / ref)
    non_silent = db > -trim_db
    idx = np.nonzero(non_silent)[0]
    if len(idx) == 0:
        return wav[:0]
    start = int(idx[0] * hop_length)
    end = min(len(wav), int((idx[-1] + 1) * hop_length))
    return wav[start:end]


def volume_norm(*, x: np.ndarray = None, coef: float = 0.95, **kwargs) -> np.ndarray:
    return x / abs(x).max() * coef


def rms_norm(*, wav: np.ndarray = None, db_level: float = -27.0, **kwargs) -> np.ndarray:
    r = 10 ** (db_level / 20)
    a = np.sqrt((len(wav) * (r**2)) / np.sum(wav**2))
    return wav * a


def rms_volume_norm(*, x: np.ndarray, db_level: float = -27.0, **kwargs) -> np.ndarray:
    assert -99 <= db_level <= 0, " [!] db_level should be between -99 and 0"
    return rms_norm(wav=x, db_level=db_level)


# --------------------------------------------------------------------------
# I/O
# --------------------------------------------------------------------------


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
