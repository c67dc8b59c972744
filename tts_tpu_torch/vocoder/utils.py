"""Vocoder glue (port of ``tts_tpu/vocoder/utils.py``):
``interpolate_vocoder_input``, copied unchanged (numpy), and
``make_generator_from_config``, which builds the port's generator module."""

from __future__ import annotations

import inspect

import numpy as np


def interpolate_vocoder_input(scale_factor, spec: np.ndarray) -> np.ndarray:
    """Rescale a spectrogram in time when the TTS model's and the vocoder's
    sample rates differ (torch ``F.interpolate``, bilinear,
    ``align_corners=False``, on the time axis). ``spec`` ``[C, T]`` →
    ``[C, floor(T * scale)]``."""
    scale = float(scale_factor[1] if isinstance(scale_factor, (list, tuple)) else scale_factor)
    C, T = spec.shape
    T_out = int(np.floor(T * scale))
    # torch bilinear align_corners=False coordinate mapping:
    # in_x = (out_x + 0.5) / scale - 0.5
    out_x = (np.arange(T_out, dtype=np.float64) + 0.5) / scale - 0.5
    x0 = np.floor(out_x).astype(np.int64)
    frac = (out_x - x0).astype(spec.dtype)
    x0c = np.clip(x0, 0, T - 1)
    x1c = np.clip(x0 + 1, 0, T - 1)
    return spec[:, x0c] * (1.0 - frac) + spec[:, x1c] * frac


def make_generator_from_config(config, **overrides):
    """The generator named by ``config.generator_model``, built from its
    parameters as the JAX package builds it (``tts_tpu/vocoder/utils.py:29-62``):
    ``generator_model_params``, else ``model_params`` (WaveGrad, a UnivNet
    config), else ``model_args`` (WaveRNN); the mel width fills the field
    that takes it (``in_channels``, ParallelWaveGAN's ``aux_channels``,
    UnivNet's ``cond_channels``, WaveRNN's ``feat_dims``, which also takes
    the config's ``mode`` and ``mulaw`` and the folded norms of a converted
    checkpoint). The flax modules infer their input widths from the mel, so
    the JAX package sets no ``in_channels`` for the iSTFT generator and
    WaveGrad; the port's modules need it, and take the mel width there too.
    Parameters the module does not take (such as ``use_weight_norm``,
    folded away by the converter) are dropped; ``overrides`` replace the
    config's (the ``Synthesizer``'s WaveRNN with layer norms)."""
    from tts_tpu_torch.vocoder.models import setup_generator

    name = config.generator_model.lower()
    params = dict(getattr(config, "generator_model_params", None) or {})
    if not params:
        params = dict(getattr(config, "model_params", None) or {})
    if not params:
        params = dict(getattr(config, "model_args", None) or {})
    num_mels = config.audio.num_mels
    cls = setup_generator(name)
    if "melgan" in name or name in ("hifigan_generator", "istft_hifigan_generator", "wavegrad"):
        params.setdefault("in_channels", num_mels)
    elif name == "parallel_wavegan_generator":
        params.setdefault("aux_channels", num_mels)
    elif name == "univnet_generator":
        params.setdefault("cond_channels", num_mels)
    elif name == "wavernn":
        params.setdefault("feat_dims", num_mels)
        params.setdefault("mode", getattr(config, "mode", "mold"))
        params.setdefault("mulaw", getattr(config, "mulaw", True))
        params.setdefault("norm_type", "folded")
    params.update(overrides)
    valid = set()
    for klass in cls.__mro__:
        if klass.__init__ is not object.__init__ and "__init__" in vars(klass):
            valid |= set(inspect.signature(klass.__init__).parameters)
    params = {k: v for k, v in params.items() if k in valid - {"self", "args", "kwargs"}}
    return cls(**params)
