"""Text → waveform or mel for one sentence (port of
``tts_tpu/utils/synthesis.py``): VITS, which emits the waveform, and
GlowTTS, Tacotron2 and the ForwardTTS family, which emit a mel for a
vocoder or Griffin-Lim.

The JAX package's rules are kept, since the audio depends on them:

* the token ids are padded to a multiple of ``config.pad_to_multiple_text``
  (16), with the true length in ``x_lengths``;
* the frame budget is 12 frames per token in buckets of 128, at most 4096
  (:func:`_frame_budget`); a model with a durations pass (VITS) decodes at
  its predicted length rounded up to a multiple of 32 within that: the model
  decodes the whole budget without a frame mask, so the last frames of an
  utterance depend on the padded tail, and an exact-length decode would
  differ there. GlowTTS and ForwardTTS have no durations pass and decode at
  the budget, which cuts a sentence predicted longer (as in the JAX
  package). An
  autoregressive model (Tacotron2, which has a reduction factor ``r``)
  decodes at most ``max(1, budget // r)`` steps of ``r`` frames, its decode's
  ``r`` (ROADMAP.md F20), and stops where every row has stopped;
* the waveform is cut to ``y_lengths × hop`` samples, a mel to
  ``y_lengths`` frames (``mel_lengths`` for an autoregressive model), which
  Griffin-Lim turns into a waveform on the host when asked
  (``use_griffin_lim`` with the model's ``AudioProcessor``);
* a style reference ``style_wav`` (a path or an array) becomes the
  ``AudioProcessor``'s mel ``[1, T, M]`` in ``aux_input["style_mel"]``, and
  ``style_text`` goes into ``aux_input`` as it is (no model reads it,
  ROADMAP.md F37).

Tacotron v1 (``config.model == "tacotron"``) emits a linear spectrogram,
which Griffin-Lim inverts through ``AudioProcessor.inv_spectrogram``; the
JAX package inverts it as a mel (ROADMAP.md F40).

:func:`decode_packed` decodes several utterances at once as one
sequence-packed grid (``utils/packing.py``), for the ``Synthesizer``'s
multi-sentence requests and the server's ``DynamicBatcher``;
:func:`plan_decode_groups` splits a batch of a model without a packed
decode into a few length groups for the batcher;
:func:`trim_silence` cuts a waveform at its first long quiet stretch
(``AudioProcessor.find_endpoint``), as the JAX ``Synthesizer`` does for a
model loaded from a checkpoint file.

There is no compile step and no cache: each call runs eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tts_tpu_torch.utils.packing import plan_pack_layout, unpack_outputs


def _frame_budget(n_tokens: int) -> int:
    """A generous 12 frames per token, rounded up to 128, at most 4096."""
    est = max(n_tokens * 12, 128)
    return min(((est + 127) // 128) * 128, 4096)


# The fixed cost of one more decode dispatch, in frame·row units: one
# dispatch's floor (ms) over the marginal ms of one latent frame in one
# row, both measured on the MB-iSTFT VITS at full width by chip_smoke.py
# phase 9 (DECODE_GROUP_FIT). The JAX package's 2048 was fitted on its TPU
# and is not used here.
DECODE_GROUP_FIT = ("NVIDIA H100 80GB HBM3, 700.00 W: floor 34.99 ms per dispatch, "
                    "4.265 us per frame-row")
DECODE_GROUP_OVERHEAD = 8205  # 34.99 ms / 4.265 us


def plan_decode_groups(y_preds, multiple: int = 32, cap: int = 4096,
                       overhead: int = DECODE_GROUP_OVERHEAD, max_groups: int = 3):
    """Partition a batch by predicted decode length into at most
    ``max_groups`` groups, each decoded at its own frame bucket (port of
    ``tts_tpu/utils/synthesis.py:20-72``).

    Sorted by length, the batch is split into contiguous groups by a small
    dynamic program minimising ``sum_g bucket(max y in g) * |g| + overhead *
    (n_groups - 1)``, where ``bucket`` rounds up to ``multiple`` (at most
    ``cap``) and ``overhead`` is one more dispatch's fixed cost in
    frame·row units: mixed lengths split where the padding saved pays for
    the dispatch, matched ones stay in one group. Returns ``[(indices,
    bucket), ...]``, shortest group first, ``indices`` into the original
    order. Models with a sequence-packed decode do better packed
    (``utils/packing.py``); this serves the others."""
    n = len(y_preds)
    order = sorted(range(n), key=lambda i: int(y_preds[i]))
    ys = [max(1, int(y_preds[i])) for i in order]

    def _bucket(v: int) -> int:
        return min(((v + multiple - 1) // multiple) * multiple, cap)

    # best[i][k]: (cost, split points) covering the first i sorted items
    # with k groups; sorted order makes each group's max its last element
    best = [[None] * (max_groups + 1) for _ in range(n + 1)]
    best[0][0] = (0.0, ())
    for i in range(1, n + 1):
        for k in range(1, max_groups + 1):
            cand = None
            for j in range(i):
                prev = best[j][k - 1]
                if prev is None:
                    continue
                c = prev[0] + _bucket(ys[i - 1]) * (i - j) + (overhead if k > 1 else 0)
                if cand is None or c < cand[0]:
                    cand = (c, prev[1] + (j,))
            best[i][k] = cand
    win = min((b for b in best[n][1:] if b is not None), key=lambda t: t[0])
    splits = list(win[1]) + [n]
    return [(order[a:b], _bucket(ys[b - 1])) for a, b in zip(splits[:-1], splits[1:])]


def aux_input(device, rows: int, speaker_ids=None, d_vectors=None,
              language_ids=None) -> Optional[Dict[str, torch.Tensor]]:
    """The model's conditioning inputs for ``rows`` rows on ``device``:
    ``speaker_ids`` and ``language_ids`` (one int each, or one per row),
    ``d_vectors`` (one vector, or one per row; a given d-vector takes the
    place of a speaker id, as in the JAX package). ``None`` when nothing is
    given."""
    aux = {}
    if d_vectors is not None:
        d = torch.as_tensor(np.asarray(d_vectors, np.float32))
        aux["d_vectors"] = d.reshape(-1, d.shape[-1]).expand(rows, -1).to(device)
    elif speaker_ids is not None:
        aux["speaker_ids"] = torch.as_tensor(speaker_ids).expand(rows).long().to(device)
    if language_ids is not None:
        aux["language_ids"] = torch.as_tensor(language_ids).expand(rows).long().to(device)
    return aux or None


def style_input(aux: Optional[Dict[str, Any]], device, style_wav=None, style_text=None,
                ap=None) -> Optional[Dict[str, Any]]:
    """``aux`` with the style mel of ``style_wav`` (a path, or samples;
    ``ap.melspectrogram``, as ``[1, T, M]`` on ``device``) and
    ``style_text`` added; ``style_wav`` without ``ap`` raises the JAX
    package's ``ValueError``."""
    aux = dict(aux or {})
    if style_wav is not None:
        if ap is None:
            raise ValueError(
                "style_wav was given but no AudioProcessor is available to "
                "compute the style mel; pass `ap` or precompute the style.")
        if isinstance(style_wav, str):
            style_wav = ap.load_wav(style_wav)
        mel = ap.melspectrogram(np.asarray(style_wav, np.float32))
        aux["style_mel"] = torch.from_numpy(np.ascontiguousarray(mel.T[None])).to(device)
    if style_text is not None:
        aux["style_text"] = style_text
    return aux or None


def synthesis(model, text: str, speaker_id: Optional[int] = None, d_vector=None,
              language_id: Optional[int] = None, language: Optional[str] = None,
              use_griffin_lim: bool = False, ap=None, style_wav=None,
              style_text: Optional[str] = None) -> Dict[str, Any]:
    """Tokenize → (durations) → decode → cut. ``model`` is a host wrapper
    with ``tokenizer``, ``config``, ``device``, ``hop_length``,
    ``emits_waveform`` and ``inference`` (:class:`~tts_tpu_torch.models.vits.model.Vits`,
    :class:`~tts_tpu_torch.models.glow_tts.model.GlowTTS`,
    :class:`~tts_tpu_torch.models.tacotron2.model.Tacotron2`, which also has
    ``r``). A VITS also has
    ``infer_durations``; each of its calls seeds its own generator, so the
    durations pass draws the noise that the decode after it draws.
    ``speaker_id``, ``d_vector`` and ``language_id`` condition a
    multi-speaker or multi-language model; ``language``, the language's
    name, goes to the tokenizer, whose ``multi_phonemizer`` picks its
    phonemizer by it (the JAX package passes none, so its multi-phonemizer
    models cannot synthesize: ROADMAP.md F14). ``style_wav`` and
    ``style_text`` style a GST or Capacitron model (:func:`style_input`).
    Returns the float32 ``wav``
    (numpy; for a mel model ``None`` unless ``use_griffin_lim`` with ``ap``),
    ``model_outputs`` (a mel model's ``[T, C]`` mel, numpy), the model's
    ``outputs`` and the padded ``text_inputs``."""
    token_ids = model.tokenizer.text_to_ids(text, language)
    bucket = int(getattr(model.config, "pad_to_multiple_text", 16) or 16)
    n_tokens = max(1, len(token_ids))
    padded_len = ((n_tokens + bucket - 1) // bucket) * bucket
    ids = np.zeros((1, padded_len), np.int64)
    ids[0, : len(token_ids)] = token_ids
    x = torch.from_numpy(ids).to(model.device)
    x_lengths = torch.tensor([n_tokens], device=model.device)
    aux = style_input(aux_input(model.device, 1, speaker_id, d_vector, language_id),
                      model.device, style_wav, style_text, ap)

    budget = _frame_budget(len(token_ids))
    if hasattr(model, "infer_durations"):
        y_len = int(model.infer_durations(x, x_lengths, aux_input=aux).max())
        budget = min(budget, ((y_len + 31) // 32) * 32)
    if hasattr(model, "r"):  # autoregressive: decoder steps of r frames, to the first stop
        outputs = model.inference(x, x_lengths, max_steps=max(1, budget // model.r),
                                  aux_input=aux)
        valid_frames = int(outputs["mel_lengths"][0])
    else:
        outputs = model.inference(x, x_lengths, max_frames=budget, aux_input=aux)
        valid_frames = int(outputs["y_lengths"][0])
    if model.emits_waveform:
        wav = outputs["model_outputs"][0, : valid_frames * model.hop_length, 0]
        return {"wav": wav.float().cpu().numpy(), "model_outputs": None, "outputs": outputs,
                "text_inputs": x}
    mel = outputs["model_outputs"][0, :valid_frames].float().cpu().numpy()
    wav = None
    if use_griffin_lim and ap is not None:
        linear = model.config.model == "tacotron"
        wav = ap.inv_spectrogram(mel.T) if linear else ap.inv_melspectrogram(mel.T)
    return {"wav": wav, "model_outputs": mel, "outputs": outputs, "text_inputs": x}


def decode_packed(model, x: torch.Tensor, x_lengths: torch.Tensor, n: int, budget: int,
                  aux: Optional[Dict[str, torch.Tensor]] = None) -> List[np.ndarray]:
    """The first ``n`` rows of the padded id batch ``x`` in one
    sequence-packed decode: durations pass, plan, ``inference_packed`` with
    noise drawn in the grid's layout, unpack. ``aux`` (:func:`aux_input`)
    holds each row's speaker and language; rows of one grid may differ in
    both. Each utterance's frames are capped at ``budget`` and at
    ``max_inference_len``, as ``Vits.inference`` caps its frames. Returns
    the float32 waveforms (numpy)."""
    durations = model.infer_durations(x, x_lengths, aux_input=aux)[:n].cpu().numpy()
    cap = min(budget, int(model.args.max_inference_len or budget))
    plan = plan_pack_layout(np.minimum(durations, cap))
    out = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                 noise_frames=budget, noise_layout="packed", aux_input=aux)
    grid = out["model_outputs"][..., 0].float().cpu().numpy()  # [R, L * hop]
    return unpack_outputs(grid, plan, upsample=model.hop_length)


def trim_silence(wav: np.ndarray, ap) -> np.ndarray:
    """``wav`` up to its endpoint (``ap.find_endpoint``: the first 0.8 s
    window below ``-trim_db`` dB)."""
    return wav[: ap.find_endpoint(wav)]
