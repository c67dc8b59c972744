"""Tortoise redaction: wav2vec2-CTC audio ↔ text alignment (port of
``tts_tpu/models/tortoise/wav2vec_alignment.py``; reference
``TTS/tts/layers/tortoise/wav2vec_alignment.py``).

Tortoise lets users bracket text ("[this] is redacted") and cuts the
bracketed spans out of the generated audio by CTC-aligning the expected
text against wav2vec2 logits. The backbone runs on the port's WavLM
(wav2vec2-large-robust is its pre-LN variant with a layer-norm conv
extractor) with a CTC head; the weights convert from the HF
``Wav2Vec2ForCTC`` state dict through :func:`convert_hf_wav2vec2_ctc` (a
copy of the JAX package's, which reuses HuBERT's converter). The character
vocabulary is passed in (the reference downloads
``jbetker/tacotron-symbols``; nothing is fetched here).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.vc.modules.wavlm import WavLM, WavLMConfig

__all__ = [
    "max_alignment",
    "wav2vec2_large_robust_config",
    "Wav2Vec2CTC",
    "convert_hf_wav2vec2_ctc",
    "load_wav2vec2_ctc",
    "Wav2VecAlignment",
]


def wav2vec2_large_robust_config() -> WavLMConfig:
    """wav2vec2-large-robust's dims (pre-LN, layer-norm conv extractor)."""
    return WavLMConfig(
        extractor_mode="layer_norm",
        encoder_layers=24,
        encoder_embed_dim=1024,
        encoder_ffn_embed_dim=4096,
        encoder_attention_heads=16,
        layer_norm_first=True,
        conv_bias=True,
        relative_position_embedding=False,
        gru_rel_pos=False,
    )


class Wav2Vec2CTC(nn.Module):
    """wav ``[B, T]`` (zero mean, unit variance) → CTC logits ``[B, T', vocab]``."""

    def __init__(self, cfg: WavLMConfig, vocab_size: int = 182):
        super().__init__()
        self.wav2vec2 = WavLM(cfg)
        self.lm_head = nn.Linear(cfg.encoder_embed_dim, vocab_size)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.wav2vec2(wav))


def convert_hf_wav2vec2_ctc(state: dict) -> dict:
    """HF ``Wav2Vec2ForCTC`` state dict → flax :class:`Wav2Vec2CTC` params."""
    from tts_tpu_torch.models.bark.hubert import convert_hf_hubert
    from tts_tpu_torch.utils.convert import linear_kernel

    s = {k: np.asarray(v) for k, v in state.items()}
    backbone = {k[len("wav2vec2."):]: v for k, v in s.items() if k.startswith("wav2vec2.")}
    p = convert_hf_hubert(backbone)["params"]
    # layer-norm extractor mode: per-conv layer norms instead of gn_0
    fe = p["feature_extractor"]
    fe.pop("gn_0", None)
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in backbone:
        if f"feature_extractor.conv_layers.{i}.layer_norm.weight" in backbone:
            fe[f"ln_{i}"] = {
                "scale": backbone[f"feature_extractor.conv_layers.{i}.layer_norm.weight"],
                "bias": backbone[f"feature_extractor.conv_layers.{i}.layer_norm.bias"],
            }
        i += 1
    return {
        "params": {
            "wav2vec2": p,
            "lm_head": {
                "kernel": linear_kernel(s["lm_head.weight"]),
                "bias": s["lm_head.bias"],
            },
        }
    }


def load_wav2vec2_ctc(state: Mapping, cfg: WavLMConfig = None, device="cuda") -> Wav2Vec2CTC:
    """An HF ``Wav2Vec2ForCTC`` state dict (numpy or tensors) → the port's
    :class:`Wav2Vec2CTC` on ``device`` (``cfg`` defaults to
    wav2vec2-large-robust; the vocabulary's size is read off the head)."""
    from tts_tpu_torch.utils.convert import _to_numpy, flax_to_state_dict

    state = {k: _to_numpy(v) for k, v in state.items()}
    with torch.device("meta"):
        model = Wav2Vec2CTC(cfg or wav2vec2_large_robust_config(),
                            vocab_size=state["lm_head.weight"].shape[0])
    device = resolve_device(device)
    weights = flax_to_state_dict(convert_hf_wav2vec2_ctc(state))
    model.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def max_alignment(s1: str, s2: str, skip_character: str = "~") -> str:
    """Align ``s1`` into ``s2`` preserving order; characters of ``s1`` with
    no match become ``skip_character``. The JAX package's bottom-up rewrite
    of the reference's memoized recursion, with its exact semantics
    (first-character matches are taken greedily; score ties prefer
    consuming ``s1``)."""
    assert skip_character not in s1, f"skip character {skip_character} in {s1!r}"
    n, m = len(s1), len(s2)
    # cell[i][j] = (aligned string, matched count) for s1[i:] against s2[j:]
    cell = [[("", 0)] * (m + 1) for _ in range(n + 1)]
    for i in range(n, -1, -1):
        for j in range(m, -1, -1):
            if i == n:
                cell[i][j] = ("", 0)
            elif j == m:
                cell[i][j] = (skip_character * (n - i), 0)
            elif s1[i] == s2[j]:
                sub, sc = cell[i + 1][j + 1]
                cell[i][j] = (s1[i] + sub, sc + 1)
            else:
                t1, sc1 = cell[i][j + 1]  # skip a character of s2
                t2, sc2 = cell[i + 1][j]  # give up on s1[i]
                if sc1 > sc2:
                    cell[i][j] = (t1, sc1)
                else:
                    cell[i][j] = (skip_character + t2, sc2)
    return cell[0][0][0]


class Wav2VecAlignment:
    """CTC audio ↔ text alignment and bracket redaction (reference
    ``Wav2VecAlignment``). ``vocab``: character → token id;
    ``logits_fn(wav [1, T at 16 kHz]) → [T', vocab]`` gives the CTC logits
    (a loaded :class:`Wav2Vec2CTC`, or any callable)."""

    def __init__(self, logits_fn, vocab: Dict[str, int], pad_token: int = 0):
        self.logits_fn = logits_fn
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.pad_token = pad_token

    def _decode(self, ids: Sequence[int]) -> str:
        out = []
        prev = None
        for t in ids:  # CTC collapse: repeats merged, padding dropped
            if t != prev and t != self.pad_token:
                out.append(self.inv_vocab.get(int(t), ""))
            prev = t
        return "".join(out)

    def _ctc_frame_ids(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Greedy token id a frame, for the audio at 16 kHz, normalised."""
        from tts_tpu_torch.audio.numpy_transforms import resample_wav

        wav = np.asarray(audio, np.float32)
        if sample_rate != 16000:
            wav = resample_wav(wav, sample_rate, 16000)
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        if isinstance(self.logits_fn, nn.Module):
            dev = next(self.logits_fn.parameters()).device
            with torch.no_grad():
                logits = self.logits_fn(torch.from_numpy(wav[None]).to(dev)).float().cpu().numpy()
        else:
            logits = np.asarray(self.logits_fn(wav[None]))
        if logits.ndim == 3:
            logits = logits[0]
        return logits.argmax(-1).astype(np.int64)

    @staticmethod
    def _fill_gaps(offsets: np.ndarray) -> np.ndarray:
        """Each ``-1`` replaced by integer linear interpolation between the
        anchors around it (exact ``//`` arithmetic)."""
        miss = offsets < 0
        if not miss.any():
            return offsets
        idx = np.arange(len(offsets))
        anchors = idx[~miss]
        prev = anchors[np.searchsorted(anchors, idx, side="right") - 1]
        nxt = anchors[np.searchsorted(anchors, idx, side="left").clip(max=len(anchors) - 1)]
        a, b = offsets[prev], offsets[nxt]
        span = np.maximum(nxt - prev, 1)
        interp = a + (idx - prev) * (b - a) // span
        return np.where(miss, interp, offsets)

    def align(self, audio: np.ndarray, expected_text: str,
              audio_sample_rate: int = 24000) -> List[int]:
        """The sample offset of each character of ``expected_text`` in
        ``audio`` (reference ``wav2vec_alignment.py:55``): characters the CTC
        pass cannot match are interpolated between their matched
        neighbours; a character whose token never appears in the remaining
        frames is an error."""
        samples = len(audio)
        frame_ids = self._ctc_frame_ids(audio, audio_sample_rate)
        samples_per_frame = samples // len(frame_ids)

        heard = self._decode(frame_ids.tolist())
        # the expected text projected onto what was heard; unheard
        # characters become "~" and are interpolated
        matched_text = max_alignment(expected_text.lower(), heard)
        if len(matched_text) <= 1:
            return [0]

        offsets = np.full(len(matched_text), -1, np.int64)
        offsets[0] = 0
        cursor = 0  # the frames before it are consumed
        for pos, ch in enumerate(matched_text[1:], start=1):
            if ch == "~":
                continue
            token = self.vocab.get(ch, -2)
            hits = np.flatnonzero(frame_ids[cursor:] == token)
            if not hits.size:
                raise RuntimeError(
                    f"alignment failed at char {pos} ({ch!r}): token {token} "
                    f"not found after frame {cursor} "
                    f"({(offsets >= 0).sum()}/{len(expected_text)} chars aligned)"
                )
            cursor += int(hits[0]) + 1
            offsets[pos] = (cursor - 1) * samples_per_frame

        # the unheard characters interpolated; the audio's end anchors the tail
        offsets = self._fill_gaps(np.append(offsets, samples))[:-1]
        return offsets.tolist()

    def redact(self, audio: np.ndarray, expected_text: str,
               audio_sample_rate: int = 24000) -> np.ndarray:
        """The ``[bracketed]`` spans cut out of the audio (reference
        ``redact``: brackets do not nest; each kept span ends at its last
        character's start offset)."""
        import re

        if "[" not in expected_text:
            return audio
        parts = re.split(r"\[([^\[\]]*)\]", expected_text)  # even indices are kept
        assert "[" not in "".join(parts) and "]" not in "".join(parts), (
            'every "[" must pair with a "]" (no nesting)'
        )
        starts = np.cumsum([0] + [len(p) for p in parts])
        keep = [
            (starts[i], max(0, starts[i] + len(p) - 1))
            for i, p in enumerate(parts) if i % 2 == 0 and p
        ]
        offsets = self.align(audio, "".join(parts), audio_sample_rate)
        pieces = [audio[offsets[a]: offsets[b]] for a, b in keep]
        pieces = [p for p in pieces if len(p)]
        return np.concatenate(pieces) if pieces else audio
