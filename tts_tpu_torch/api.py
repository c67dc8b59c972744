"""User-facing Python API of the port (counterpart of ``tts_tpu/api.py``).

Example::

    >>> from tts_tpu_torch.api import TTS
    >>> tts = TTS(model_path="xtts_v2/")  # config.json, vocab.json, weights
    >>> tts.tts_to_file("Hello world.", speaker_wav="ref.wav", language="en",
    ...                 file_path="out.wav")
    >>> vits = TTS(model_path="vits/model_torch.pt", config_path="vits/config.json")
    >>> vits.tts_to_file("Hello world.", file_path="out.wav")
    >>> vctk = TTS(model_path="vctk/", speakers_file_path="vctk/speakers.json")
    >>> vctk.speakers[:2]
    ['p225', 'p226']
    >>> vctk.tts_to_file("Hello world.", speaker="p226", file_path="out.wav")
    >>> TTS.list_models()[:1]
    ['tts_models/multilingual/multi-dataset/xtts_v2']
    >>> zoo = TTS("tts_models/en/vctk/vits")  # from $TTS_HOME/tts_tpu/, fetched if absent
    >>> glow = TTS(model_path="glow/model_file.pth", config_path="glow/config.json",
    ...            vocoder_path="mbmelgan/model_file.pth",
    ...            vocoder_config_path="mbmelgan/config.json")
    >>> TTS("tts_models/en/ljspeech/glow-tts")  # with its default vocoder, Multiband-MelGAN
    >>> yourtts = TTS(model_path="yourtts/model_file.pth", config_path="yourtts/config.json",
    ...               encoder_path="se/model_se.pth.tar", encoder_config_path="se/config_se.json")
    >>> yourtts.tts_to_file("Hello world.", speaker_wav="ref.wav", language="en",
    ...                     file_path="out.wav")
    >>> TTS("tts_models/en/ljspeech/fast_pitch")  # FastPitch with HiFiGAN v2
    >>> vc = TTS("voice_conversion_models/multilingual/vctk/freevc24")  # FreeVC
    >>> vc.voice_conversion_to_file(source_wav="a.wav", target_wav="b.wav",
    ...                             file_path="out.wav")
    >>> vits.tts_with_vc_to_file("Hello world.", speaker_wav="b.wav", file_path="out.wav")

A zoo name loads through ``utils.manage.ModelManager``: a VITS, GlowTTS,
Tacotron2 or FastPitch entry from its reference-layout checkpoint file and
``config.json``, XTTS v2 from its directory, and an entry's
``default_vocoder`` with it unless a ``vocoder_path`` is given. YourTTS
(``tts_models/multilingual/multi-dataset/your_tts``) also loads the speaker
encoder its directory ships (``model_se.pth.tar``, ``config_se.json``) unless
an ``encoder_path`` is given. A ``voice_conversion_models/`` name loads a
voice converter (FreeVC) in place of a TTS model, WavLM-Large read from
``$TTS_HOME/wavlm/WavLM-Large.pt`` on its first conversion (nothing is
fetched for it). Every other family raises
``NotImplementedError`` naming its ROADMAP.md item before anything is
fetched (``utils.manage.unported_reason``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tts_tpu_torch.utils.manage import ModelManager, unported_reason
from tts_tpu_torch.utils.synthesizer import Synthesizer


def download_vocoder(vocoder_name: str,
                     manager: Optional[ModelManager] = None) -> Tuple[str, Optional[str]]:
    """A zoo vocoder's ``(checkpoint, config.json)``, fetched if absent,
    after checking that the port runs it (the command line's and the
    server's ``--vocoder_name``)."""
    manager = manager or ModelManager()
    if not vocoder_name.startswith("vocoder_models/"):
        raise ValueError(f"{vocoder_name} is not a vocoder_models/ entry")
    reason = unported_reason(vocoder_name, manager.models_dict)
    if reason:
        raise NotImplementedError(f"{vocoder_name}: {reason}")
    vocoder_path, vocoder_config, _ = manager.download_model(vocoder_name)
    return vocoder_path, vocoder_config


class TTS:
    """Facade over :class:`Synthesizer`. ``model_name`` is a zoo name;
    ``model_path`` a model directory or a checkpoint file with its
    ``config_path``; ``vocoder_path`` (with ``vocoder_config_path``) a
    vocoder for a mel model, in place of a zoo entry's default vocoder;
    ``speakers_file_path`` and ``language_ids_file_path`` replace the
    config's speaker and language files; ``encoder_path`` (with
    ``encoder_config_path``) is the speaker encoder that turns a
    ``speaker_wav`` into a d-vector for a d-vector model. A
    ``model_name`` that contains ``voice_conversion`` loads a voice
    converter (``voice_converter``) instead of a TTS model. ``device``
    defaults to ``"cuda"`` and must exist."""

    def __init__(self, model_name: str = "", model_path: Optional[str] = None,
                 config_path: Optional[str] = None, vocoder_path: Optional[str] = None,
                 vocoder_config_path: Optional[str] = None, device="cuda",
                 speakers_file_path: Optional[str] = None,
                 language_ids_file_path: Optional[str] = None,
                 encoder_path: Optional[str] = None, encoder_config_path: Optional[str] = None):
        self.synthesizer: Optional[Synthesizer] = None
        self.voice_converter: Optional[Synthesizer] = None
        self.model_name = model_name
        self.device = device
        self._speakers_file_path = speakers_file_path or ""
        self._language_ids_file_path = language_ids_file_path or ""
        self._encoder_path = encoder_path or ""
        self._encoder_config_path = encoder_config_path or ""
        if model_name and "voice_conversion" in model_name:
            self.load_vc_model_by_name(model_name)
        elif model_name:
            self.load_tts_model_by_name(model_name, vocoder_path, vocoder_config_path)
        elif model_path:
            self.load_tts_model_by_path(model_path, config_path, vocoder_path,
                                        vocoder_config_path)

    @staticmethod
    def list_models() -> List[str]:
        """Every name of the zoo catalog."""
        return ModelManager().list_models()

    def load_tts_model_by_name(self, model_name: str, vocoder_path: Optional[str] = None,
                               vocoder_config: Optional[str] = None) -> None:
        """A zoo model by name (port of ``tts_tpu/api.py:88-122``): its files
        from the data directory, fetched if absent, after the family (and
        its default vocoder's) is known to be ported; then its
        ``default_vocoder`` the same way, unless ``vocoder_path`` is given."""
        manager = ModelManager()
        reason = unported_reason(model_name, manager.models_dict)
        if reason:
            raise NotImplementedError(f"{model_name}: {reason}")
        if model_name.startswith("vocoder_models/"):
            raise ValueError(f"{model_name} is a vocoder: give it as vocoder_path, or to the "
                             f"command line as --vocoder_name")
        model_path, config_path, model_item = manager.download_model(model_name)
        if vocoder_path is None and model_item.get("default_vocoder"):
            vocoder_path, vocoder_config = download_vocoder(model_item["default_vocoder"],
                                                            manager)
        self.load_tts_model_by_path(model_path, config_path, vocoder_path, vocoder_config)

    def load_tts_model_by_path(self, model_path: str, config_path: Optional[str] = None,
                               vocoder_path: Optional[str] = None,
                               vocoder_config: Optional[str] = None) -> None:
        self.synthesizer = Synthesizer(
            tts_checkpoint=model_path, tts_config_path=config_path or "", device=self.device,
            speakers_file_path=self._speakers_file_path,
            language_ids_file_path=self._language_ids_file_path,
            vocoder_checkpoint=vocoder_path or "", vocoder_config=vocoder_config or "",
            encoder_checkpoint=self._encoder_path, encoder_config=self._encoder_config_path,
        )

    def load_vc_model_by_name(self, model_name: str) -> None:
        """A zoo voice-conversion model by name (port of ``tts_tpu/api.py:128``):
        its files from the data directory, fetched if absent, after the
        family is known to be ported."""
        manager = ModelManager()
        reason = unported_reason(model_name, manager.models_dict)
        if reason:
            raise NotImplementedError(f"{model_name}: {reason}")
        model_path, config_path, _ = manager.download_model(model_name)
        self.load_vc_model_by_path(model_path, config_path)

    def load_vc_model_by_path(self, model_path: str, config_path: Optional[str] = None) -> None:
        """A voice-conversion checkpoint file with its config."""
        self.voice_converter = Synthesizer(vc_checkpoint=model_path, vc_config=config_path or "",
                                           device=self.device)

    def _manager(self, name: str):
        model = self.synthesizer.tts_model if self.synthesizer else None
        return getattr(model, name, None)

    def _is_xtts(self) -> bool:
        return self.synthesizer is not None and self.synthesizer.tts_config.model == "xtts"

    @property
    def is_multi_speaker(self) -> bool:
        """Whether the model holds more than one speaker to choose from: a
        multi-speaker VITS, or an XTTS model with its built-in speakers
        (``speakers_xtts.pth``)."""
        return len(self.speakers) > 1

    @property
    def speakers(self) -> List[str]:
        """The speaker names of the model's speaker manager."""
        sm = self._manager("speaker_manager")
        if self._is_xtts():
            return list(sm or {})
        return list(sm.name_to_id) if sm is not None else []

    @property
    def is_multi_lingual(self) -> bool:
        """XTTS, or a VITS model with more than one language."""
        return self._is_xtts() or len(self.languages) > 1

    @property
    def languages(self) -> List[str]:
        """XTTS's languages (its config's ``languages``), or the names of a
        VITS model's language manager."""
        if self._is_xtts():
            return list(self.synthesizer.tts_config.languages or [])
        lm = self._manager("language_manager")
        return list(lm.name_to_id) if lm is not None else []

    def _require_model(self) -> Synthesizer:
        if self.synthesizer is None:
            raise RuntimeError("No model loaded.")
        return self.synthesizer

    def tts(self, text: str, speaker: Optional[str] = None, language: Optional[str] = None,
            speaker_wav=None, style_wav=None, style_text: Optional[str] = None,
            split_sentences: bool = True, **kwargs):
        """Text → waveform samples; ``style_wav`` (a path or samples) and
        ``style_text`` style a GST or Capacitron model."""
        return self._require_model().tts(
            text, speaker_name=speaker, language_name=language, speaker_wav=speaker_wav,
            style_wav=style_wav, style_text=style_text, split_sentences=split_sentences,
            **kwargs,
        )

    def tts_to_file(self, text: str, speaker: Optional[str] = None,
                    language: Optional[str] = None, speaker_wav=None, style_wav=None,
                    style_text: Optional[str] = None, file_path: str = "output.wav",
                    pipe_out=None, split_sentences: bool = True, **kwargs) -> str:
        """Text → wav file."""
        wav = self.tts(text, speaker=speaker, language=language, speaker_wav=speaker_wav,
                       style_wav=style_wav, style_text=style_text,
                       split_sentences=split_sentences, **kwargs)
        self._require_model().save_wav(wav, file_path, pipe_out=pipe_out)
        return file_path

    def tts_stream(self, text: str, speaker: Optional[str] = None,
                   language: Optional[str] = None, speaker_wav=None,
                   split_sentences: bool = True, **kwargs):
        """Yield float32 audio chunks as they decode."""
        return self._require_model().tts_stream(
            text, speaker_name=speaker, language_name=language, speaker_wav=speaker_wav,
            split_sentences=split_sentences, **kwargs,
        )

    def voice_conversion(self, source_wav: str, target_wav):
        """``source_wav`` spoken in the voice of ``target_wav`` (port of
        ``tts_tpu/api.py:215``): waveform samples at the converter's
        ``output_sample_rate``."""
        converter = self.voice_converter or self.synthesizer
        if converter is None:
            raise RuntimeError("No model loaded.")
        return converter.voice_conversion(source_wav=source_wav, target_wav=target_wav)

    def voice_conversion_to_file(self, source_wav: str, target_wav: str,
                                 file_path: str = "output.wav") -> str:
        """:meth:`voice_conversion` into a wav file."""
        wav = self.voice_conversion(source_wav=source_wav, target_wav=target_wav)
        (self.voice_converter or self.synthesizer).save_wav(wav, file_path)
        return file_path

    def tts_with_vc(self, text: str, language: Optional[str] = None, speaker_wav=None,
                    speaker: Optional[str] = None, split_sentences: bool = True):
        """Synthesize ``text``, then convert it into the voice of
        ``speaker_wav`` (port of ``tts_tpu/api.py:231``); the zoo's
        ``freevc24`` is loaded by name when no converter is. The
        intermediate wav file is removed afterwards, where the JAX package
        leaves it in the temporary directory."""
        import os
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        try:
            self.tts_to_file(text=text, speaker=speaker, language=language, file_path=path,
                             split_sentences=split_sentences)
            if self.voice_converter is None:
                self.load_vc_model_by_name("voice_conversion_models/multilingual/vctk/freevc24")
            return self.voice_converter.voice_conversion(source_wav=path, target_wav=speaker_wav)
        finally:
            os.remove(path)

    def tts_with_vc_to_file(self, text: str, language: Optional[str] = None, speaker_wav=None,
                            file_path: str = "output.wav", speaker: Optional[str] = None,
                            split_sentences: bool = True) -> str:
        """:meth:`tts_with_vc` into a wav file."""
        wav = self.tts_with_vc(text=text, language=language, speaker_wav=speaker_wav,
                               speaker=speaker, split_sentences=split_sentences)
        self.voice_converter.save_wav(wav, file_path)
        return file_path
