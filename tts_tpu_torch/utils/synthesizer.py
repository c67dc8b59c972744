"""Synthesizer: load a model directory once, render text many times (port of
``tts_tpu/utils/synthesizer.py`` for the model-directory families, XTTS so
far).

A model directory holds ``config.json``, ``vocab.json`` and weights: the
port's ``model_torch.pt`` or a reference-layout ``model.pth``.
"""

from __future__ import annotations

import os
import re
import time
from typing import List, Optional

import numpy as np
import torch

from tts_tpu_torch import resolve_device
from tts_tpu_torch.audio.numpy_transforms import save_wav
from tts_tpu_torch.config import read_json_with_comments
from tts_tpu_torch.models import config_from_dict, setup_model

_SENTENCE_RE = re.compile(r"(?<=[.!?;:])\s+(?=[^\s])")


def split_into_sentences(text: str) -> List[str]:
    """Split after sentence punctuation followed by whitespace."""
    text = text.strip()
    if not text:
        return []
    return [p.strip() for p in _SENTENCE_RE.split(text) if p.strip()]


class Synthesizer:
    def __init__(self, model_dir: str = "", device="cuda"):
        self.device = resolve_device(device)
        self.tts_model = None
        self.tts_config = None
        self.output_sample_rate = 24000
        if model_dir:
            self._load_tts_from_dir(model_dir)

    def _load_tts_from_dir(self, model_dir: str) -> None:
        config = config_from_dict(read_json_with_comments(os.path.join(model_dir, "config.json")))
        # build on the meta device: the checkpoint's tensors are assigned,
        # so nothing is allocated twice
        with torch.device("meta"):
            model = setup_model(config)
        self.tts_model = model.load_checkpoint(config, checkpoint_dir=model_dir, device=self.device)
        self.tts_config = config
        self.output_sample_rate = config.model_args.output_sample_rate

    # ------------------------------------------------------------------
    def tts(
        self,
        text: str = "",
        speaker_name: Optional[str] = None,
        language_name: Optional[str] = None,
        speaker_wav=None,
        split_sentences: bool = True,
        **kwargs,
    ) -> List[float]:
        """Text → waveform samples, sentence by sentence, with 10000 zero
        samples after each sentence."""
        start = time.time()
        if not text:
            raise ValueError("You need to define `text` to use the TTS API.")
        sens = split_into_sentences(text) if split_sentences else [text.strip()]
        if not sens:
            raise ValueError("No text to speak.")
        wavs: List[float] = []
        for sen in sens:
            outputs = self.tts_model.synthesize(
                text=sen, config=self.tts_config, speaker_id=speaker_name,
                speaker_wav=speaker_wav, language=language_name or "en", **kwargs,
            )
            wavs += list(np.asarray(outputs["wav"], np.float32))
            wavs += [0] * 10000
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs

    def tts_stream(
        self,
        text: str,
        speaker_name: Optional[str] = None,
        language_name: Optional[str] = None,
        speaker_wav=None,
        split_sentences: bool = True,
        **kwargs,
    ):
        """Yield float32 audio chunks as they decode, sentence by sentence."""
        sens = split_into_sentences(text) if split_sentences else [text.strip()]
        if not any(sens):
            raise ValueError("No text to speak.")
        for sen in sens:
            yield from self.tts_model.synthesize_stream(
                text=sen, config=self.tts_config, speaker_id=speaker_name,
                speaker_wav=speaker_wav, language=language_name or "en", **kwargs,
            )

    def save_wav(self, wav: List[float], path: str, pipe_out=None) -> None:
        save_wav(wav=np.asarray(wav), path=path, sample_rate=self.output_sample_rate,
                 pipe_out=pipe_out)
