"""Vocoder generator registry of the port (port of ``setup_generator`` in
``tts_tpu/vocoder/models/__init__.py``): every generator of the JAX package,
HiFiGAN, the MelGAN family, ParallelWaveGAN, UnivNet, the iSTFT generator,
WaveGrad and WaveRNN, inference only. The discriminators and the training
wrappers serve training and wait for it (ROADMAP.md item 17)."""

from __future__ import annotations

import importlib

_GENERATORS = {
    "hifigan_generator": "tts_tpu_torch.vocoder.models.hifigan_generator:HifiganGenerator",
    "melgan_generator": "tts_tpu_torch.vocoder.models.melgan_generator:MelganGenerator",
    "multiband_melgan_generator":
        "tts_tpu_torch.vocoder.models.melgan_generator:MultibandMelganGenerator",
    "fullband_melgan_generator":
        "tts_tpu_torch.vocoder.models.melgan_generator:FullbandMelganGenerator",
    "parallel_wavegan_generator":
        "tts_tpu_torch.vocoder.models.parallel_wavegan_generator:ParallelWaveganGenerator",
    "univnet_generator": "tts_tpu_torch.vocoder.models.univnet_generator:UnivnetGenerator",
    "istft_hifigan_generator": "tts_tpu_torch.vocoder.models.istft_hifigan:IstftHifiganGenerator",
    "wavegrad": "tts_tpu_torch.vocoder.models.wavegrad:Wavegrad",
    "wavernn": "tts_tpu_torch.vocoder.models.wavernn:Wavernn",
}


def setup_generator(name: str):
    """The generator class registered under ``name``."""
    key = name.lower()
    if key not in _GENERATORS:
        raise ModuleNotFoundError(f" [!] Unknown vocoder module {name!r}")
    mod_name, cls_name = _GENERATORS[key].split(":")
    return getattr(importlib.import_module(mod_name), cls_name)
