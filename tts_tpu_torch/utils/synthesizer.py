"""Synthesizer: load a model once, render text many times (port of
``tts_tpu/utils/synthesizer.py`` for XTTS and VITS).

A model loads from a directory (``config.json`` plus weights: the port's
``model_torch.pt`` or a reference-layout ``model.pth``; XTTS also needs its
``vocab.json``) or, for VITS, from a checkpoint file and its
``config.json``.

Models with their own ``synthesize`` (XTTS) render each sentence through
it. The others (VITS) go through :func:`~tts_tpu_torch.utils.synthesis.synthesis`
one sentence at a time. That serial loop is what the JAX package's
``Synthesizer`` runs for a vocoder-less VITS by default: its sequence-packed
multi-sentence path is gated on ``not use_gl``, which its default
``use_griffin_lim=True`` makes false (ROADMAP.md fault F1).
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
from tts_tpu_torch.utils.synthesis import synthesis

_SENTENCE_RE = re.compile(r"(?<=[.!?;:])\s+(?=[^\s])")
SENTENCE_GAP = 10000  # zero samples after each sentence (reference synthesizer.py:441)


def split_into_sentences(text: str) -> List[str]:
    """Split after sentence punctuation followed by whitespace."""
    text = text.strip()
    if not text:
        return []
    return [p.strip() for p in _SENTENCE_RE.split(text) if p.strip()]


class Synthesizer:
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", model_dir: str = "",
                 device="cuda"):
        self.device = resolve_device(device)
        self.tts_model = None
        self.tts_config = None
        self.output_sample_rate = 24000
        path = model_dir or tts_checkpoint
        if path:
            if not tts_config_path:
                if not os.path.isdir(path):
                    raise ValueError("a checkpoint file needs its config.json (tts_config_path)")
                tts_config_path = os.path.join(path, "config.json")
            self._load_tts(path, tts_config_path)

    def _load_tts(self, path: str, config_path: str) -> None:
        """A model directory, or a VITS checkpoint file, with its config."""
        config = config_from_dict(read_json_with_comments(config_path))
        # build on the meta device: the checkpoint's tensors are assigned,
        # so nothing is allocated twice
        with torch.device("meta"):
            model = setup_model(config)
        if os.path.isdir(path):
            model = model.load_checkpoint(config, checkpoint_dir=path, device=self.device)
        elif config.model == "vits":
            model = model.load_checkpoint(config, checkpoint_path=path, device=self.device)
        else:
            raise ValueError(f"{config.model!r} loads from a model directory, not a file")
        self.tts_model = model
        self.tts_config = config  # as loaded, as the JAX package keeps it (/details shows it)
        self.output_sample_rate = (getattr(config.model_args, "output_sample_rate", None)
                                   or config.audio.sample_rate)

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
        model = self.tts_model
        wavs: List[float] = []
        if hasattr(model, "synthesize"):
            for sen in sens:
                outputs = model.synthesize(
                    text=sen, config=self.tts_config, speaker_id=speaker_name,
                    speaker_wav=speaker_wav, language=language_name or "en", **kwargs,
                )
                wavs += list(np.asarray(outputs["wav"], np.float32))
                wavs += [0] * SENTENCE_GAP
        else:
            given = {"speaker_name": speaker_name, "language_name": language_name,
                     "speaker_wav": speaker_wav, **kwargs}
            given = sorted(k for k, v in given.items() if v is not None)
            if given:
                raise ValueError(f"{self.tts_config.model!r} is a single-speaker, "
                                 f"single-language model: {', '.join(given)} not taken")
            for sen in sens:
                wavs += list(synthesis(model, sen)["wav"])
                wavs += [0] * SENTENCE_GAP
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
        """Yield float32 audio chunks as they decode, sentence by sentence
        (streaming models only, XTTS)."""
        if not hasattr(self.tts_model, "synthesize_stream"):
            raise NotImplementedError(
                f"Model {self.tts_config.model!r} has no streaming path; use tts() instead."
            )
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
