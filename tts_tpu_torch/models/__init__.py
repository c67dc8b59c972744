"""Model registry of the port: config name → (config class, model class),
and the vocoder configs by name.

XTTS, VITS and GlowTTS are ported so far, with the HiFiGAN and MelGAN
vocoders (``vocoder.models.setup_generator``); other names raise.
"""

from __future__ import annotations

import importlib
from typing import Dict

_MODELS = {
    "xtts": ("tts_tpu_torch.models.xtts.config:XttsConfig", "tts_tpu_torch.models.xtts.model:Xtts"),
    "vits": ("tts_tpu_torch.models.vits.config:VitsConfig", "tts_tpu_torch.models.vits.model:Vits"),
    "glow_tts": ("tts_tpu_torch.models.glow_tts.config:GlowTTSConfig",
                 "tts_tpu_torch.models.glow_tts.model:GlowTTS"),
}
_VOCODER_CONFIGS = {
    "hifigan": "tts_tpu_torch.vocoder.configs:HifiganConfig",
    "melgan": "tts_tpu_torch.vocoder.configs:MelganConfig",
    "multiband_melgan": "tts_tpu_torch.vocoder.configs:MultibandMelganConfig",
    "fullband_melgan": "tts_tpu_torch.vocoder.configs:FullbandMelganConfig",
}
_UNPORTED_VOCODERS = ("parallel_wavegan", "univnet", "wavegrad", "wavernn", "gan")


def _load(entry: str):
    mod, name = entry.split(":")
    return getattr(importlib.import_module(mod), name)


def _entry(model_name: str):
    name = (model_name or "").lower()
    if name not in _MODELS:
        raise ValueError(
            f" [!] Model {model_name!r} is not ported to tts_tpu_torch yet "
            f"(ported: {sorted(_MODELS)})"
        )
    return _MODELS[name]


def _process_model_name(config_dict: Dict) -> str:
    """The model name of a ``config.json`` dict: ``model``, or for legacy
    vocoder configs ``generator_model`` without its ``_generator`` suffix
    (copied from ``tts_tpu/config/__init__.py:95``)."""
    model_name = config_dict["model"] if "model" in config_dict else config_dict.get("generator_model", "")
    model_name = model_name.replace("_generator", "").replace("_discriminator", "")
    return model_name


def config_from_dict(config_dict: Dict):
    """A ``config.json`` dict → the port's config object for its model or
    vocoder."""
    name = _process_model_name(config_dict).lower()
    if name in _VOCODER_CONFIGS:
        return _load(_VOCODER_CONFIGS[name]).from_dict(config_dict)
    if name in _UNPORTED_VOCODERS:
        raise NotImplementedError(f"the {name!r} vocoder is not ported to tts_tpu_torch yet "
                                  f"(ROADMAP.md item 16)")
    return _load(_entry(name)[0]).from_dict(config_dict)


def setup_model(config):
    """Config → an (unloaded) model module."""
    return _load(_entry(config.model)[1]).init_from_config(config)
