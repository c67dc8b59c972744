"""Vocoder generator registry of the port (port of ``setup_generator`` in
``tts_tpu/vocoder/models/__init__.py``): the HiFiGAN and MelGAN generators.
Every other generator of the JAX package raises ``NotImplementedError``
naming its ROADMAP.md item."""

from __future__ import annotations

import importlib

_GENERATORS = {
    "hifigan_generator": "tts_tpu_torch.vocoder.models.hifigan_generator:HifiganGenerator",
    "melgan_generator": "tts_tpu_torch.vocoder.models.melgan_generator:MelganGenerator",
    "multiband_melgan_generator":
        "tts_tpu_torch.vocoder.models.melgan_generator:MultibandMelganGenerator",
    "fullband_melgan_generator":
        "tts_tpu_torch.vocoder.models.melgan_generator:FullbandMelganGenerator",
}
_UNPORTED = {
    "parallel_wavegan_generator": "ROADMAP.md item 16",
    "univnet_generator": "ROADMAP.md item 16",
    "istft_hifigan_generator": "ROADMAP.md item 16",
    "wavegrad": "ROADMAP.md item 16",
    "wavernn": "ROADMAP.md item 16",
}


def setup_generator(name: str):
    """The generator class registered under ``name``."""
    key = name.lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"the vocoder generator {name!r} is not ported to "
                                  f"tts_tpu_torch yet ({_UNPORTED[key]})")
    if key not in _GENERATORS:
        raise ModuleNotFoundError(f" [!] Unknown vocoder module {name!r}")
    mod_name, cls_name = _GENERATORS[key].split(":")
    return getattr(importlib.import_module(mod_name), cls_name)
