"""Text → waveform for one sentence (port of ``tts_tpu/utils/synthesis.py``
for the end-to-end waveform models, VITS so far).

The JAX package's rules are kept, since the audio depends on them:

* the token ids are padded to a multiple of ``config.pad_to_multiple_text``
  (16), with the true length in ``x_lengths``;
* the frame budget is the duration pass's predicted length rounded up to a
  multiple of 32 (never above a generous 12 frames per token): the model
  decodes the whole budget without a frame mask, so the last frames of an
  utterance depend on the padded tail, and an exact-length decode would
  differ there;
* the waveform is cut to ``y_lengths × hop`` samples.

:func:`decode_packed` decodes several utterances at once as one
sequence-packed grid (``utils/packing.py``), for the ``Synthesizer``'s
multi-sentence requests and the server's ``DynamicBatcher``;
:func:`trim_silence` cuts a waveform at its first long quiet stretch, as
the JAX ``Synthesizer`` does for a model loaded from a checkpoint file.

There is no compile step and no cache: each call runs eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from tts_tpu_torch.audio.numpy_transforms import find_endpoint
from tts_tpu_torch.utils.packing import plan_pack_layout, unpack_outputs

_LOG_BASE = {"np.log10": 10, "np.log": np.e}  # AudioProcessor's log_func → base


def _frame_budget(n_tokens: int) -> int:
    """A generous 12 frames per token, rounded up to 128, at most 4096."""
    est = max(n_tokens * 12, 128)
    return min(((est + 127) // 128) * 128, 4096)


def synthesis(model, text: str) -> Dict[str, Any]:
    """Tokenize → durations → decode → cut. ``model`` is a host wrapper with
    ``tokenizer``, ``config``, ``device``, ``hop_length``,
    ``infer_durations`` and ``inference`` (:class:`~tts_tpu_torch.models.vits.model.Vits`),
    each call of which seeds its own generator: the durations pass draws the
    noise that the decode after it draws. Returns the float32 ``wav``
    (numpy), the model's ``outputs`` and the padded ``text_inputs``."""
    token_ids = model.tokenizer.text_to_ids(text)
    bucket = int(getattr(model.config, "pad_to_multiple_text", 16) or 16)
    n_tokens = max(1, len(token_ids))
    padded_len = ((n_tokens + bucket - 1) // bucket) * bucket
    ids = np.zeros((1, padded_len), np.int64)
    ids[0, : len(token_ids)] = token_ids
    x = torch.from_numpy(ids).to(model.device)
    x_lengths = torch.tensor([n_tokens], device=model.device)

    y_len = int(model.infer_durations(x, x_lengths).max())
    budget = min(_frame_budget(len(token_ids)), ((y_len + 31) // 32) * 32)
    outputs = model.inference(x, x_lengths, max_frames=budget)
    valid_frames = int(outputs["y_lengths"][0])
    wav = outputs["model_outputs"][0, : valid_frames * model.hop_length, 0]
    return {
        "wav": wav.float().cpu().numpy(),
        "outputs": outputs,
        "text_inputs": x,
    }


def decode_packed(model, x: torch.Tensor, x_lengths: torch.Tensor, n: int,
                  budget: int) -> List[np.ndarray]:
    """The first ``n`` rows of the padded id batch ``x`` in one
    sequence-packed decode: durations pass, plan, ``inference_packed`` with
    noise drawn in the grid's layout, unpack. Each utterance's frames are
    capped at ``budget`` and at ``max_inference_len``, as ``Vits.inference``
    caps its frames. Returns the float32 waveforms (numpy)."""
    durations = model.infer_durations(x, x_lengths)[:n].cpu().numpy()
    cap = min(budget, int(model.args.max_inference_len or budget))
    plan = plan_pack_layout(np.minimum(durations, cap))
    out = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                 noise_frames=budget, noise_layout="packed")
    grid = out["model_outputs"][..., 0].float().cpu().numpy()  # [R, L * hop]
    return unpack_outputs(grid, plan, upsample=model.hop_length)


def trim_silence(wav: np.ndarray, audio_config) -> np.ndarray:
    """``wav`` up to its endpoint, as the JAX ``AudioProcessor.find_endpoint``
    cuts it: ``trim_db``, ``spec_gain``, the base of ``log_func`` and
    ``sample_rate`` from ``audio_config``, and the ``AudioProcessor``'s
    defaults (60 dB, 20, ``np.log10``) for the fields it lacks, as a
    ``VitsAudioConfig`` lacks all three."""
    end = find_endpoint(wav=wav, trim_db=getattr(audio_config, "trim_db", 60),
                        sample_rate=audio_config.sample_rate,
                        gain=float(getattr(audio_config, "spec_gain", 20)),
                        base=_LOG_BASE[getattr(audio_config, "log_func", "np.log10")])
    return wav[:end]
