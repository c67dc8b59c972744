"""User-facing Python API of the port (counterpart of ``tts_tpu/api.py``).

Example::

    >>> from tts_tpu_torch.api import TTS
    >>> tts = TTS(model_path="xtts_v2/")  # config.json, vocab.json, weights
    >>> tts.tts_to_file("Hello world.", speaker_wav="ref.wav", language="en",
    ...                 file_path="out.wav")
    >>> vits = TTS(model_path="vits/model_torch.pt", config_path="vits/config.json")
    >>> vits.tts_to_file("Hello world.", file_path="out.wav")
"""

from __future__ import annotations

from typing import Optional

from tts_tpu_torch.utils.synthesizer import Synthesizer


class TTS:
    """Facade over :class:`Synthesizer`. ``model_path`` is a model directory
    or a checkpoint file with its ``config_path``. ``device`` defaults to
    ``"cuda"`` and must exist."""

    def __init__(self, model_path: Optional[str] = None, config_path: Optional[str] = None,
                 device="cuda"):
        self.synthesizer: Optional[Synthesizer] = None
        if model_path:
            self.synthesizer = Synthesizer(tts_checkpoint=model_path,
                                           tts_config_path=config_path or "", device=device)

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
