"""Vocoder registries of the port (port of
``tts_tpu/vocoder/models/__init__.py``): every generator of the JAX package
(HiFiGAN, the MelGAN family, ParallelWaveGAN, UnivNet, the iSTFT generator,
WaveGrad and WaveRNN), every discriminator (HiFiGAN's, MelGAN's single and
multi-scale, UnivNet's, ParallelWaveGAN's, the random window one), and
``setup_model``, the training wrapper a vocoder config names: WaveGrad's and
WaveRNN's own (``WavegradVocoder``, ``WavernnVocoder``, trained through the
trainer's generic step) or, for every GAN family, ``GAN``."""

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

_DISCRIMINATORS = {
    "hifigan_discriminator":
        "tts_tpu_torch.vocoder.models.hifigan_discriminator:HifiganDiscriminator",
    "melgan_multiscale_discriminator":
        "tts_tpu_torch.vocoder.models.melgan_discriminator:MelganMultiscaleDiscriminator",
    "univnet_discriminator":
        "tts_tpu_torch.vocoder.models.univnet_discriminator:UnivnetDiscriminator",
    "parallel_wavegan_discriminator":
        "tts_tpu_torch.vocoder.models.parallel_wavegan_generator:ParallelWaveganDiscriminator",
    "random_window_discriminator":
        "tts_tpu_torch.vocoder.models.random_window_discriminator:RandomWindowDiscriminator",
    "melgan_discriminator": "tts_tpu_torch.vocoder.models.melgan_discriminator:MelganDiscriminator",
}


def _resolve(table, name: str):
    key = name.lower()
    if key not in table:
        raise ModuleNotFoundError(f" [!] Unknown vocoder module {name!r}")
    mod_name, cls_name = table[key].split(":")
    return getattr(importlib.import_module(mod_name), cls_name)


def setup_generator(name: str):
    """The generator class registered under ``name``."""
    return _resolve(_GENERATORS, name)


def setup_discriminator(name: str):
    """The discriminator class registered under ``name``."""
    return _resolve(_DISCRIMINATORS, name)


def setup_model(config):
    """The training wrapper for a vocoder config, by ``config.model``
    (reference ``vocoder/models/__init__.py:12``): ``wavegrad`` and
    ``wavernn`` their own, every GAN family (``hifigan``, ``melgan``,
    ``multiband_melgan``, ``fullband_melgan``, ``parallel_wavegan``,
    ``univnet``, ``gan``) the generator x discriminator wrapper."""
    name = (config.model or "gan").lower()
    if name == "wavegrad":
        from tts_tpu_torch.vocoder.models.wavegrad import WavegradVocoder

        return WavegradVocoder(config)
    if name == "wavernn":
        from tts_tpu_torch.vocoder.models.wavernn import WavernnVocoder

        return WavernnVocoder(config)
    from tts_tpu_torch.vocoder.models.gan import GAN

    return GAN(config)
