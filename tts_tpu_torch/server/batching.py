"""Dynamic cross-request batching for ``/api/tts`` (port of
``tts_tpu/server/batching.py``).

HTTP requests arrive one at a time; decoding them one after another pays
the host's dispatch cost once per sentence. Here concurrent requests are
split into sentences and queued; a worker thread takes up to ``max_batch``
sentences, waiting ``window_ms`` after the first for others to join, pads
their token ids as the JAX batcher does (batch → next power of two, text →
``pad_to_multiple_text``) and decodes them in one dispatch: a single
sentence through ``Vits.inference`` at its frame budget, several as one
sequence-packed grid (``utils.synthesis.decode_packed``). Each caller gets
its sentences' waveforms joined with the serial path's 10000-sample gap.

Serves end-to-end waveform models with a packed decode (VITS). Models with
their own ``synthesize`` (XTTS) and models without a waveform output are
refused; the server then serves serially. A request naming a speaker or a
language raises ``ValueError``, as the single-speaker ``Synthesizer``
does. An error in a dispatch is raised to every caller in it: no other
path is tried. The batcher does not trim silence, as the JAX batcher does
not (ROADMAP.md F10).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from tts_tpu_torch.utils.synthesis import _frame_budget, decode_packed
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, split_into_sentences


class _Pending:
    __slots__ = ("ids", "done", "wav", "error")

    def __init__(self, ids: np.ndarray):
        self.ids = ids
        self.done = threading.Event()
        self.wav: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class DynamicBatcher:
    """Queue and worker thread that batch concurrent ``tts()`` calls into
    one device dispatch."""

    def __init__(self, synthesizer, max_batch: int = 8, window_ms: float = 10.0):
        model = synthesizer.tts_model
        if model is None or hasattr(model, "synthesize"):
            raise ValueError("DynamicBatcher needs a generic-inference TTS model")
        if not getattr(model, "emits_waveform", False):
            raise ValueError(
                "DynamicBatcher needs a model whose inference() emits a waveform "
                "directly (emits_waveform=True, e.g. VITS)"
            )
        if not model.supports_packed_decode:
            raise ValueError("DynamicBatcher needs a model with a sequence-packed decode")
        self.synthesizer = synthesizer
        self.model = model
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def tts(self, text: str, speaker_name: Optional[str] = None,
            language_name: Optional[str] = None) -> List[float]:
        """Blocking per-request entry: split into sentences as the serial
        path does, enqueue each, wait for the worker, join with the serial
        path's gap."""
        given = sorted(k for k, v in (("speaker_name", speaker_name),
                                      ("language_name", language_name)) if v is not None)
        if given:
            raise ValueError(f"{self.synthesizer.tts_config.model!r} is a single-speaker, "
                             f"single-language model: {', '.join(given)} not taken")
        sens = split_into_sentences(text) or [text.strip()]
        items = []
        for sen in sens:
            ids = self.model.tokenizer.text_to_ids(sen)
            if ids:
                items.append(_Pending(np.asarray(ids, np.int64)))
        if not items:
            raise ValueError("No text to speak.")
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.extend(items)
            self._cond.notify()
        wavs: List[float] = []
        for item in items:
            item.done.wait()
            if item.error is not None:
                raise item.error
            wavs += list(item.wav)
            wavs += [0] * SENTENCE_GAP
        return wavs

    def close(self) -> None:
        """Stop the worker once the queue is empty, and wait for it."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=60)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # the first sentence opens a short window for others to join
                deadline = time.monotonic() + self.window_s
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = [self._queue.popleft()
                         for _ in range(min(self.max_batch, len(self._queue)))]
            try:
                self._dispatch(batch)
            except Exception as e:  # raised to each caller of the batch
                for it in batch:
                    it.error = e
                    it.done.set()

    def _dispatch(self, batch: List[_Pending]) -> None:
        """Decode ``batch`` and hand each item its waveform: one sentence at
        its frame budget through ``inference`` (capped at
        ``max_inference_len`` there), several as one packed grid."""
        model = self.model
        budget = _frame_budget(max(len(it.ids) for it in batch))
        x, x_lengths = self._pad(batch)
        if len(batch) == 1:
            out = model.inference(x, x_lengths, max_frames=budget)
            frames = int(out["y_lengths"][0])
            wavs = [out["model_outputs"][0, : frames * model.hop_length, 0].float().cpu().numpy()]
        else:
            wavs = decode_packed(model, x, x_lengths, len(batch), budget)
        for it, wav in zip(batch, wavs):
            it.wav = wav
            it.done.set()

    def _pad(self, batch: List[_Pending]):
        """Token ids padded into a batch of the next power of two rows and a
        multiple of ``pad_to_multiple_text`` columns: ``(x, x_lengths)``.
        The rows past the batch have length 1."""
        cfg = self.model.config
        bucket = int(getattr(cfg, "pad_to_multiple_text", 16) or 16)
        longest = max(len(it.ids) for it in batch)
        width = ((longest + bucket - 1) // bucket) * bucket
        rows = _next_pow2(len(batch))
        x = np.zeros((rows, width), np.int64)
        x_lengths = np.ones((rows,), np.int64)
        for row, it in enumerate(batch):
            x[row, : len(it.ids)] = it.ids
            x_lengths[row] = len(it.ids)
        device = self.model.device
        return torch.from_numpy(x).to(device), torch.from_numpy(x_lengths).to(device)
