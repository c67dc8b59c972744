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

A zoo name loads through ``utils.manage.ModelManager``: a VITS or GlowTTS
entry from its reference-layout checkpoint file and ``config.json``, XTTS v2
from its directory, and an entry's ``default_vocoder`` with it unless a
``vocoder_path`` is given. Every other family raises
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
    config's speaker and language files. ``device`` defaults to ``"cuda"``
    and must exist."""

    def __init__(self, model_name: str = "", model_path: Optional[str] = None,
                 config_path: Optional[str] = None, vocoder_path: Optional[str] = None,
                 vocoder_config_path: Optional[str] = None, device="cuda",
                 speakers_file_path: Optional[str] = None,
                 language_ids_file_path: Optional[str] = None):
        self.synthesizer: Optional[Synthesizer] = None
        self.model_name = model_name
        self.device = device
        self._speakers_file_path = speakers_file_path or ""
        self._language_ids_file_path = language_ids_file_path or ""
        if model_name:
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
        )

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
            speaker_wav=None, split_sentences: bool = True, **kwargs):
        """Text → waveform samples."""
        return self._require_model().tts(
            text, speaker_name=speaker, language_name=language, speaker_wav=speaker_wav,
            split_sentences=split_sentences, **kwargs,
        )

    def tts_to_file(self, text: str, speaker: Optional[str] = None,
                    language: Optional[str] = None, speaker_wav=None,
                    file_path: str = "output.wav", pipe_out=None,
                    split_sentences: bool = True, **kwargs) -> str:
        """Text → wav file."""
        wav = self.tts(text, speaker=speaker, language=language, speaker_wav=speaker_wav,
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
