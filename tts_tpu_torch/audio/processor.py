"""``AudioProcessor``: one object carrying every audio parameter of a
``BaseAudioConfig``, on the host in numpy (port of
``tts_tpu/audio/processor.py``, copied unchanged for what the port runs):
``init_from_config``, ``normalize``/``denormalize`` (range normalisation, or
mean-var stats through ``StandardScaler`` when ``stats_path`` and
``signal_norm`` are set), ``load_stats``/``setup_scaler``, the preemphasis
pair, ``spectrogram``, ``melspectrogram``, ``inv_spectrogram`` and
``inv_melspectrogram`` through Griffin-Lim, ``find_endpoint``/``trim_silence``,
and ``load_wav``/``save_wav``.

The ``Synthesizer`` builds one per model: the TTS model's turns its mel
back into decibels, the vocoder's normalises them for the vocoder, and
Griffin-Lim speaks a mel model without one. f0 and the mu-law codecs serve
training and wait for it.
"""

from __future__ import annotations

from io import BytesIO

import numpy as np
import scipy.io.wavfile

from . import numpy_transforms as nt

__all__ = ["AudioProcessor", "StandardScaler"]


class StandardScaler:
    """Mean-std feature scaler."""

    def __init__(self, mean: np.ndarray = None, scale: np.ndarray = None):
        self.mean_ = mean
        self.scale_ = scale

    def set_stats(self, mean, scale):
        self.mean_ = mean
        self.scale_ = scale

    def reset_stats(self):
        self.mean_ = None
        self.scale_ = None

    def transform(self, X):
        X = np.asarray(X)
        return (X - self.mean_) / self.scale_

    def inverse_transform(self, X):
        X = np.asarray(X)
        return X * self.scale_ + self.mean_


class AudioProcessor:
    """See the module docstring. Constructor arguments mirror
    ``BaseAudioConfig``."""

    def __init__(
        self,
        sample_rate=None,
        resample=False,
        num_mels=None,
        log_func="np.log10",
        min_level_db=None,
        frame_shift_ms=None,
        frame_length_ms=None,
        hop_length=None,
        win_length=None,
        ref_level_db=None,
        fft_size=1024,
        power=None,
        preemphasis=0.0,
        signal_norm=None,
        symmetric_norm=None,
        max_norm=None,
        mel_fmin=None,
        mel_fmax=None,
        pitch_fmax=None,
        pitch_fmin=None,
        spec_gain=20,
        stft_pad_mode="reflect",
        clip_norm=True,
        griffin_lim_iters=None,
        do_trim_silence=False,
        trim_db=60,
        do_sound_norm=False,
        do_amp_to_db_linear=True,
        do_amp_to_db_mel=True,
        do_rms_norm=False,
        db_level=None,
        stats_path=None,
        verbose=True,
        **kwargs,
    ):
        self.sample_rate = sample_rate
        self.resample = resample
        self.num_mels = num_mels
        self.log_func = log_func
        self.min_level_db = min_level_db or 0
        self.frame_shift_ms = frame_shift_ms
        self.frame_length_ms = frame_length_ms
        self.ref_level_db = ref_level_db
        self.fft_size = fft_size
        self.power = power
        self.preemphasis = preemphasis
        self.griffin_lim_iters = griffin_lim_iters
        self.signal_norm = signal_norm
        self.symmetric_norm = symmetric_norm
        self.mel_fmin = mel_fmin or 0
        self.mel_fmax = mel_fmax
        self.pitch_fmin = pitch_fmin
        self.pitch_fmax = pitch_fmax
        self.spec_gain = float(spec_gain)
        self.stft_pad_mode = stft_pad_mode
        self.max_norm = 1.0 if max_norm is None else float(max_norm)
        self.clip_norm = clip_norm
        self.do_trim_silence = do_trim_silence
        self.trim_db = trim_db
        self.do_sound_norm = do_sound_norm
        self.do_amp_to_db_linear = do_amp_to_db_linear
        self.do_amp_to_db_mel = do_amp_to_db_mel
        self.do_rms_norm = do_rms_norm
        self.db_level = db_level
        self.stats_path = stats_path
        if log_func == "np.log":
            self.base = np.e
        elif log_func == "np.log10":
            self.base = 10
        else:
            raise ValueError(" [!] unknown `log_func` value.")
        if hop_length is None:
            self.win_length, self.hop_length = nt.millisec_to_length(
                frame_length_ms=self.frame_length_ms,
                frame_shift_ms=self.frame_shift_ms,
                sample_rate=self.sample_rate,
            )
        else:
            self.hop_length = hop_length
            self.win_length = win_length
        assert min_level_db != 0.0, " [!] min_level_db is 0"
        assert self.win_length <= self.fft_size, (
            f" [!] win_length cannot be larger than fft_size - {self.win_length} vs {self.fft_size}"
        )
        members = vars(self)
        if verbose:
            print(" > Setting up Audio Processor...")
            for key, value in members.items():
                print(f" | > {key}:{value}")
        self.mel_basis = nt.build_mel_basis(
            sample_rate=self.sample_rate,
            fft_size=self.fft_size,
            num_mels=self.num_mels,
            mel_fmax=self.mel_fmax,
            mel_fmin=self.mel_fmin,
        )
        if stats_path and signal_norm:
            mel_mean, mel_std, linear_mean, linear_std, _ = self.load_stats(stats_path)
            self.setup_scaler(mel_mean, mel_std, linear_mean, linear_std)
            self.signal_norm = True
            self.max_norm = None
            self.clip_norm = None
            self.symmetric_norm = None

    @staticmethod
    def init_from_config(config, verbose=True) -> "AudioProcessor":
        """From a model config with an ``audio`` section, or from an audio
        config itself."""
        if "audio" in config and config.audio is not None:
            audio = config.audio
            kw = audio.to_dict() if hasattr(audio, "to_dict") else dict(audio)
            return AudioProcessor(verbose=verbose, **kw)
        kw = config.to_dict() if hasattr(config, "to_dict") else dict(config)
        return AudioProcessor(verbose=verbose, **kw)

    # ---- normalization -----------------------------------------------------
    def normalize(self, S: np.ndarray) -> np.ndarray:
        S = S.copy()
        if not self.signal_norm:
            return S
        if hasattr(self, "mel_scaler"):
            if S.shape[0] == self.num_mels:
                return self.mel_scaler.transform(S.T).T
            if S.shape[0] == self.fft_size / 2:
                return self.linear_scaler.transform(S.T).T
            raise RuntimeError(" [!] Mean-Var stats does not match the given feature dimensions.")
        S -= self.ref_level_db
        S_norm = (S - self.min_level_db) / (-self.min_level_db)
        if self.symmetric_norm:
            S_norm = ((2 * self.max_norm) * S_norm) - self.max_norm
            if self.clip_norm:
                S_norm = np.clip(S_norm, -self.max_norm, self.max_norm)
            return S_norm
        S_norm = self.max_norm * S_norm
        if self.clip_norm:
            S_norm = np.clip(S_norm, 0, self.max_norm)
        return S_norm

    def denormalize(self, S: np.ndarray) -> np.ndarray:
        S_denorm = S.copy()
        if not self.signal_norm:
            return S_denorm
        if hasattr(self, "mel_scaler"):
            if S_denorm.shape[0] == self.num_mels:
                return self.mel_scaler.inverse_transform(S_denorm.T).T
            if S_denorm.shape[0] == self.fft_size / 2:
                return self.linear_scaler.inverse_transform(S_denorm.T).T
            raise RuntimeError(" [!] Mean-Var stats does not match the given feature dimensions.")
        if self.symmetric_norm:
            if self.clip_norm:
                S_denorm = np.clip(S_denorm, -self.max_norm, self.max_norm)
            S_denorm = ((S_denorm + self.max_norm) * -self.min_level_db / (2 * self.max_norm)) + self.min_level_db
            return S_denorm + self.ref_level_db
        if self.clip_norm:
            S_denorm = np.clip(S_denorm, 0, self.max_norm)
        S_denorm = (S_denorm * -self.min_level_db / self.max_norm) + self.min_level_db
        return S_denorm + self.ref_level_db

    # ---- stats -------------------------------------------------------------
    def load_stats(self, stats_path: str):
        stats = np.load(stats_path, allow_pickle=True).item()
        mel_mean = stats["mel_mean"]
        mel_std = stats["mel_std"]
        linear_mean = stats["linear_mean"]
        linear_std = stats["linear_std"]
        stats_config = stats["audio_config"]
        skip_parameters = ["griffin_lim_iters", "stats_path", "do_trim_silence", "ref_level_db", "power"]
        for key in stats_config.keys():
            if key in skip_parameters:
                continue
            if key not in ["sample_rate", "trim_db"] and key in self.__dict__:
                assert stats_config[key] == self.__dict__[key], (
                    f" [!] Audio param {key} does not match the value used for computing mean-var stats. "
                    f"{stats_config[key]} vs {self.__dict__[key]}"
                )
        return mel_mean, mel_std, linear_mean, linear_std, stats_config

    def setup_scaler(self, mel_mean, mel_std, linear_mean, linear_std) -> None:
        self.mel_scaler = StandardScaler()
        self.mel_scaler.set_stats(mel_mean, mel_std)
        self.linear_scaler = StandardScaler()
        self.linear_scaler.set_stats(linear_mean, linear_std)

    # ---- preemphasis -------------------------------------------------------
    def apply_preemphasis(self, x: np.ndarray) -> np.ndarray:
        return nt.preemphasis(x=x, coef=self.preemphasis)

    def apply_inv_preemphasis(self, x: np.ndarray) -> np.ndarray:
        return nt.deemphasis(x=x, coef=self.preemphasis)

    # ---- spectrograms ------------------------------------------------------
    def _stft_kwargs(self):
        return dict(
            fft_size=self.fft_size,
            hop_length=self.hop_length,
            win_length=self.win_length,
            pad_mode=self.stft_pad_mode,
        )

    def spectrogram(self, y: np.ndarray) -> np.ndarray:
        if self.preemphasis != 0:
            y = self.apply_preemphasis(y)
        D = nt.stft(y=y, **self._stft_kwargs())
        if self.do_amp_to_db_linear:
            S = nt.amp_to_db(x=np.abs(D), gain=self.spec_gain, base=self.base)
        else:
            S = np.abs(D)
        return self.normalize(S).astype(np.float32)

    def melspectrogram(self, y: np.ndarray) -> np.ndarray:
        if self.preemphasis != 0:
            y = self.apply_preemphasis(y)
        D = nt.stft(y=y, **self._stft_kwargs())
        S = nt.spec_to_mel(spec=np.abs(D), mel_basis=self.mel_basis)
        if self.do_amp_to_db_mel:
            S = nt.amp_to_db(x=S, gain=self.spec_gain, base=self.base)
        return self.normalize(S).astype(np.float32)

    def inv_spectrogram(self, spectrogram: np.ndarray) -> np.ndarray:
        """A normalised linear spectrogram ``[fft_size // 2 + 1, T]`` →
        waveform through Griffin-Lim (Tacotron v1's output)."""
        S = self.denormalize(spectrogram)
        S = nt.db_to_amp(x=S, gain=self.spec_gain, base=self.base)
        W = self._griffin_lim(S**self.power)
        return self.apply_inv_preemphasis(W) if self.preemphasis != 0 else W

    def inv_melspectrogram(self, mel_spectrogram: np.ndarray) -> np.ndarray:
        """A normalised mel ``[M, T]`` → waveform through Griffin-Lim."""
        D = self.denormalize(mel_spectrogram)
        S = nt.db_to_amp(x=D, gain=self.spec_gain, base=self.base)
        S = nt.mel_to_spec(mel=S, mel_basis=self.mel_basis)
        W = self._griffin_lim(S**self.power)
        return self.apply_inv_preemphasis(W) if self.preemphasis != 0 else W

    def _griffin_lim(self, S):
        return nt.griffin_lim(
            spec=S,
            num_iter=self.griffin_lim_iters,
            hop_length=self.hop_length,
            win_length=self.win_length,
            fft_size=self.fft_size,
            pad_mode=self.stft_pad_mode,
        )

    # ---- silence/volume ---------------------------------------------------
    def find_endpoint(self, wav: np.ndarray, min_silence_sec=0.8) -> int:
        return nt.find_endpoint(
            wav=wav,
            trim_db=self.trim_db,
            sample_rate=self.sample_rate,
            min_silence_sec=min_silence_sec,
            gain=self.spec_gain,
            base=self.base,
        )

    def trim_silence(self, wav: np.ndarray) -> np.ndarray:
        return nt.trim_silence(
            wav=wav,
            sample_rate=self.sample_rate,
            trim_db=self.trim_db,
            win_length=self.win_length,
            hop_length=self.hop_length,
        )

    @staticmethod
    def sound_norm(x: np.ndarray) -> np.ndarray:
        return nt.volume_norm(x=x)

    def rms_volume_norm(self, x: np.ndarray, db_level: float = None) -> np.ndarray:
        if db_level is None:
            db_level = self.db_level
        return nt.rms_volume_norm(x=x, db_level=db_level)

    # ---- I/O ---------------------------------------------------------------
    def load_wav(self, filename: str, sr: int = None) -> np.ndarray:
        if sr is not None:
            x = nt.load_wav(filename=filename, sample_rate=sr, resample=True)
        else:
            x = nt.load_wav(filename=filename, sample_rate=self.sample_rate, resample=self.resample)
        if self.do_trim_silence:
            try:
                x = self.trim_silence(x)
            except ValueError:
                print(f" [!] File cannot be trimmed for silence - {filename}")
        if self.do_sound_norm:
            x = self.sound_norm(x)
        if self.do_rms_norm:
            x = self.rms_volume_norm(x, self.db_level)
        return x

    def save_wav(self, wav: np.ndarray, path: str, sr: int = None, pipe_out=None) -> None:
        if self.do_rms_norm:
            wav_norm = self.rms_volume_norm(wav, self.db_level) * 32767
        else:
            wav_norm = wav * (32767 / max(0.01, np.max(np.abs(wav))))
        wav_norm = wav_norm.astype(np.int16)
        if pipe_out:
            wav_buffer = BytesIO()
            scipy.io.wavfile.write(wav_buffer, sr if sr else self.sample_rate, wav_norm)
            wav_buffer.seek(0)
            pipe_out.buffer.write(wav_buffer.read())
        scipy.io.wavfile.write(path, sr if sr else self.sample_rate, wav_norm)
