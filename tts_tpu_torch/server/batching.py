"""Dynamic cross-request batching for ``/api/tts`` (port of
``tts_tpu/server/batching.py``).

HTTP requests arrive one at a time; decoding them one after another pays
the host's dispatch cost once per sentence. Here concurrent requests are
split into sentences and queued; a worker thread takes up to ``max_batch``
sentences, waiting ``window_ms`` after the first for others to join, pads
their token ids as the JAX batcher does (batch → next power of two, text →
``pad_to_multiple_text``) and decodes them in one dispatch: a single
sentence through ``Vits.inference`` at its frame budget, several as one
sequence-packed grid (``utils.synthesis.decode_packed``). A model without a
packed decode (the ``istft`` and ``interpolate_z`` VITS variants, ROADMAP.md
F2) takes the JAX batcher's grouped path instead: one durations pass over
the batch, then at most two groups of similar predicted length
(``utils.synthesis.plan_decode_groups``), each decoded through
``Vits.inference`` at its own 32-frame bucket, capped at
``max_inference_len`` (F3). Each caller gets its sentences' waveforms
joined with the serial path's 10000-sample gap.

Serves end-to-end waveform models with a durations pass (VITS). Models with
their own ``synthesize`` (XTTS), mel → vocoder pipelines and models without
a waveform output (GlowTTS) are refused, as by the JAX batcher, and so is
DelightfulTTS, a waveform model in the port (ROADMAP.md F28) that has no
durations pass to plan a dispatch with; the server then serves serially. Each request's speaker and
language are resolved by the ``Synthesizer``'s rules before it is queued
(an unknown name raises ``ValueError`` there) and ride with each of its
sentences as that row's ids, so one dispatch mixes speakers and languages.
Speakers given as d-vectors are not batched, as in the JAX batcher: the
server sends them to the serial path before calling :meth:`tts`, which
raises ``ValueError`` on one. An error in a dispatch is raised to every
caller in it: no other path is tried. The batcher does not trim silence, as
the JAX batcher does not (ROADMAP.md F10).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from tts_tpu_torch.utils.synthesis import (
    _frame_budget,
    aux_input,
    decode_packed,
    plan_decode_groups,
)
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, split_into_sentences


class _Pending:
    __slots__ = ("ids", "speaker_id", "language_id", "done", "wav", "error")

    def __init__(self, ids: np.ndarray, speaker_id: Optional[int] = None,
                 language_id: Optional[int] = None):
        self.ids = ids
        self.speaker_id = speaker_id
        self.language_id = language_id
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
        if getattr(synthesizer, "vocoder_model", None) is not None:
            raise ValueError("DynamicBatcher supports end-to-end waveform models; "
                             "mel→vocoder pipelines keep the serial path")
        if not getattr(model, "emits_waveform", False):
            raise ValueError(
                "DynamicBatcher needs a model whose inference() emits a waveform "
                "directly (emits_waveform=True, e.g. VITS)"
            )
        if not hasattr(model, "infer_durations"):
            raise ValueError("DynamicBatcher plans its dispatches on a durations pass "
                             "(infer_durations, e.g. VITS), which this model lacks")
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
        """Blocking per-request entry: resolve the speaker and language,
        split into sentences as the serial path does, enqueue each, wait for
        the worker, join with the serial path's gap."""
        speaker_id, d_vector = self.synthesizer._resolve_speaker(speaker_name)
        if d_vector is not None:
            raise ValueError("d-vector speakers are served by the serial path")
        language_id = self.synthesizer._resolve_language(language_name)
        language = self.synthesizer._language_name(language_id)
        sens = split_into_sentences(text) or [text.strip()]
        items = []
        for sen in sens:
            ids = self.model.tokenizer.text_to_ids(sen, language)
            if ids:
                items.append(_Pending(np.asarray(ids, np.int64), speaker_id, language_id))
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
        ``max_inference_len`` there), several as one packed grid, or in
        length groups where the model has no packed decode."""
        model = self.model
        budget = _frame_budget(max(len(it.ids) for it in batch))
        if len(batch) > 1 and not model.supports_packed_decode:
            self._dispatch_grouped(batch, budget)
            return
        x, x_lengths = self._pad(batch)
        aux = self._aux(batch, x.shape[0])
        if len(batch) == 1:
            wavs = self._decode(x, x_lengths, budget, aux)
        else:
            wavs = decode_packed(model, x, x_lengths, len(batch), budget, aux)
        for it, wav in zip(batch, wavs):
            it.wav = wav
            it.done.set()

    def _decode(self, x, x_lengths, frames: int, aux) -> List[np.ndarray]:
        """``inference`` of the padded rows at ``frames``; each row's
        waveform cut at its ``y_lengths``."""
        out = self.model.inference(x, x_lengths, max_frames=frames, aux_input=aux)
        lengths = out["y_lengths"].cpu().numpy()
        wav = out["model_outputs"][..., 0].float().cpu().numpy()
        hop = self.model.hop_length
        return [wav[row, : int(n) * hop] for row, n in enumerate(lengths)]

    def _dispatch_grouped(self, batch: List[_Pending], budget: int) -> None:
        """The JAX batcher's grouped path (``tts_tpu/server/batching.py:185-210``):
        the durations pass over the whole batch plans at most two length
        groups in 32-frame buckets, and each group decodes at its bucket,
        capped at ``max_inference_len`` (F3), in a batch of its own. Each
        group's decode draws its own duration noise, as in the JAX
        package."""
        model = self.model
        x, x_lengths = self._pad(batch)
        y_pred = model.infer_durations(x, x_lengths, aux_input=self._aux(batch, x.shape[0]))
        y_pred = y_pred[: len(batch)].cpu().numpy()
        cap = int(model.args.max_inference_len or budget)
        groups = plan_decode_groups(y_pred, multiple=32, cap=budget, max_groups=2)
        for idx, frames in groups:
            items = [batch[i] for i in idx]
            x, x_lengths = self._pad(items)
            wavs = self._decode(x, x_lengths, min(frames, cap), self._aux(items, x.shape[0]))
            for it, wav in zip(items, wavs):
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

    def _aux(self, batch: List[_Pending], rows: int):
        """Each row's speaker and language ids (``aux_input``), or ``None``
        for a model without either; rows past the batch take id 0, as in
        the JAX batcher."""
        def per_row(ids):
            if all(i is None for i in ids):
                return None
            return [i or 0 for i in ids] + [0] * (rows - len(batch))

        return aux_input(self.model.device, rows,
                         speaker_ids=per_row([it.speaker_id for it in batch]),
                         language_ids=per_row([it.language_id for it in batch]))
