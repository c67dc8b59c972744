"""Model registry of the port: config name → (config class, model class),
and the vocoder configs by name.

XTTS, VITS, GlowTTS, Tacotron2 (with GST or Capacitron), Tacotron v1, the
ForwardTTS family (FastPitch, FastSpeech, FastSpeech2, SpeedySpeech),
Overflow, NeuralHMM, AlignTTS, DelightfulTTS, Tortoise and Bark are ported
so far, with every vocoder config of the JAX package (HiFiGAN, the MelGANs,
ParallelWaveGAN, UnivNet, WaveGrad, WaveRNN and the generic ``gan``; their
generators in ``vocoder.models.setup_generator``) the speaker encoders' configs, and FreeVC's config (``freevc``; its model is
set up by ``tts_tpu_torch.vc.models.setup_model``); other names raise.
"""

from __future__ import annotations

import importlib
from typing import Dict

_MODELS = {
    "xtts": ("tts_tpu_torch.models.xtts.config:XttsConfig", "tts_tpu_torch.models.xtts.model:Xtts"),
    "vits": ("tts_tpu_torch.models.vits.config:VitsConfig", "tts_tpu_torch.models.vits.model:Vits"),
    "glow_tts": ("tts_tpu_torch.models.glow_tts.config:GlowTTSConfig",
                 "tts_tpu_torch.models.glow_tts.model:GlowTTS"),
    "tacotron2": ("tts_tpu_torch.models.tacotron2.config:Tacotron2Config",
                  "tts_tpu_torch.models.tacotron2.model:Tacotron2"),
    "tacotron": ("tts_tpu_torch.models.tacotron2.config:TacotronConfig",
                 "tts_tpu_torch.models.tacotron2.tacotron_v1:Tacotron"),
    **{name: (f"tts_tpu_torch.models.forward_tts.config:{cls}",
              "tts_tpu_torch.models.forward_tts.model:ForwardTTS")
       for name, cls in (("fast_pitch", "FastPitchConfig"), ("fast_speech", "FastSpeechConfig"),
                         ("fastspeech2", "Fastspeech2Config"),
                         ("speedy_speech", "SpeedySpeechConfig"),
                         ("forward_tts", "ForwardTTSConfig"))},
    "overflow": ("tts_tpu_torch.models.overflow.config:OverflowConfig",
                 "tts_tpu_torch.models.overflow.model:Overflow"),
    "neuralhmm_tts": ("tts_tpu_torch.models.overflow.config:NeuralhmmTTSConfig",
                      "tts_tpu_torch.models.overflow.model:NeuralhmmTTS"),
    "align_tts": ("tts_tpu_torch.models.align_tts.config:AlignTTSConfig",
                  "tts_tpu_torch.models.align_tts.model:AlignTTS"),
    "delightful_tts": ("tts_tpu_torch.models.delightful_tts.config:DelightfulTTSConfig",
                       "tts_tpu_torch.models.delightful_tts.model:DelightfulTTS"),
    "tortoise": ("tts_tpu_torch.models.tortoise.config:TortoiseConfig",
                 "tts_tpu_torch.models.tortoise.model:Tortoise"),
    "bark": ("tts_tpu_torch.models.bark.config:BarkConfig", "tts_tpu_torch.models.bark.model:Bark"),
}
_ENCODER_CONFIGS = {
    "speaker_encoder": "tts_tpu_torch.encoder.configs:SpeakerEncoderConfig",
    "emotion_encoder": "tts_tpu_torch.encoder.configs:EmotionEncoderConfig",
}
_VC_CONFIGS = {"freevc": "tts_tpu_torch.vc.configs:FreeVCConfig"}
_VOCODER_CONFIGS = {
    "hifigan": "tts_tpu_torch.vocoder.configs:HifiganConfig",
    "melgan": "tts_tpu_torch.vocoder.configs:MelganConfig",
    "multiband_melgan": "tts_tpu_torch.vocoder.configs:MultibandMelganConfig",
    "fullband_melgan": "tts_tpu_torch.vocoder.configs:FullbandMelganConfig",
    "parallel_wavegan": "tts_tpu_torch.vocoder.configs:ParallelWaveganConfig",
    "univnet": "tts_tpu_torch.vocoder.configs:UnivnetConfig",
    "wavegrad": "tts_tpu_torch.vocoder.configs:WavegradConfig",
    "wavernn": "tts_tpu_torch.vocoder.configs:WavernnConfig",
    "gan": "tts_tpu_torch.vocoder.configs:GANConfig",
}


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
    """A ``config.json`` dict → the port's config object for its model,
    vocoder, encoder or voice-conversion model."""
    name = _process_model_name(config_dict).lower()
    if name in _VC_CONFIGS:
        return _load(_VC_CONFIGS[name]).from_dict(config_dict)
    if name in _VOCODER_CONFIGS:
        return _load(_VOCODER_CONFIGS[name]).from_dict(config_dict)
    if name in _ENCODER_CONFIGS:
        return _load(_ENCODER_CONFIGS[name]).from_dict(config_dict)
    return _load(_entry(name)[0]).from_dict(config_dict)


def setup_model(config):
    """Config → an (unloaded) model module."""
    return _load(_entry(config.model)[1]).init_from_config(config)
