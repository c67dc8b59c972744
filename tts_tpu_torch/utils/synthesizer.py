"""Synthesizer: load a model once, render text many times (port of
``tts_tpu/utils/synthesizer.py`` for XTTS and VITS).

A model loads from a directory (``config.json`` plus weights: the port's
``model_torch.pt`` or a reference-layout ``model.pth``; XTTS also needs its
``vocab.json``) or, for VITS, from a checkpoint file and its
``config.json``.

Models with their own ``synthesize`` (XTTS) render each sentence through
it. For the others (VITS), a request of two or more sentences is decoded
as one sequence-packed grid (:func:`~tts_tpu_torch.utils.synthesis.decode_packed`),
and a single sentence through :func:`~tts_tpu_torch.utils.synthesis.synthesis`.
The JAX package's ``Synthesizer`` gates its packed path on ``not use_gl``
as well, which its default ``use_griffin_lim=True`` makes false for a
vocoder-less VITS, so by default it decodes sentence by sentence; the port
takes the packed path that gate was meant to allow (ROADMAP.md F1). An
error in the packed decode reaches the caller: there is no fallback to the
serial loop.

A model loaded from a checkpoint file has each sentence cut at its first
long quiet stretch when its audio config has ``do_trim_silence`` on, as
the JAX package's does (:func:`~tts_tpu_torch.utils.synthesis.trim_silence`);
one loaded from a model directory is not trimmed. A VITS config's audio
section (``VitsAudioConfig``) has no such field, so VITS is trimmed by
neither package.
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
from tts_tpu_torch.utils.synthesis import _frame_budget, decode_packed, synthesis, trim_silence

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
        self.from_file = False  # loaded from a checkpoint file: may trim silence
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
        self.from_file = not os.path.isdir(path)
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
        """Text → waveform samples, with 10000 zero samples after each
        sentence."""
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
            if len(sens) > 1 and model.supports_packed_decode:
                pieces = self._tts_sentences_packed(sens)
            else:
                pieces = [synthesis(model, sen)["wav"] for sen in sens]
            audio = self.tts_config.audio
            trim = self.from_file and getattr(audio, "do_trim_silence", False)
            for wav in pieces:
                if trim:
                    wav = trim_silence(wav, audio)
                wavs += list(wav)
                wavs += [0] * SENTENCE_GAP
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs

    def _tts_sentences_packed(self, sens: List[str]) -> List[np.ndarray]:
        """All sentences of a request in one packed decode: one row of ids
        per sentence, padded to a multiple of ``pad_to_multiple_text``, at
        the frame budget of the padded width, as the JAX package pads
        them."""
        model = self.tts_model
        rows = [model.tokenizer.text_to_ids(sen) for sen in sens]
        bucket = int(getattr(self.tts_config, "pad_to_multiple_text", 16) or 16)
        width = max(max(len(r) for r in rows), 1)
        width = ((width + bucket - 1) // bucket) * bucket
        ids = np.zeros((len(rows), width), np.int64)
        lengths = np.ones((len(rows),), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            lengths[i] = max(1, len(r))
        x = torch.from_numpy(ids).to(model.device)
        x_lengths = torch.from_numpy(lengths).to(model.device)
        return decode_packed(model, x, x_lengths, len(rows), _frame_budget(width))

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
