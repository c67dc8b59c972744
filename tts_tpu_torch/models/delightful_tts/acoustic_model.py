"""DelightfulTTS acoustic model, inference (port of
``tts_tpu/models/delightful_tts/acoustic_model.py``: ``_norm_last`` ``:31``,
``_speaker_embedding``, ``_expand_with_durations`` and ``inference``
``:240-279``; reference ``TTS/tts/layers/delightful_tts/acoustic_model.py``).

Token embedding, conformer encoder (speaker-conditioned when the model has
speakers), the predicted utterance and phoneme prosody through their
bottlenecks, the pitch and energy embeddings, durations (``round(max((exp
- 1) · length_scale · d_control, 1))``, cut to ``max_frames``), expansion
through the monotonic path, the conformer decoder at ``max_frames`` and the
projection to the mel. The positional table is the host's numpy table,
built once per model and device at the longest length asked so far, and
read by its first rows. The aligner and the prosody encoders that read mels
serve training and wait for it (ROADMAP.md item 17): the port builds none.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch.ops.helpers import generate_path, sequence_mask

from .acoustic import (
    Conformer,
    EmbeddingPadded,
    PhonemeProsodyPredictor,
    VarianceAdaptor,
    VariancePredictor,
    positional_encoding,
)


def _norm_last(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm1d(affine=False)`` as the reference applies it to the
    prosody bottlenecks, which arrive channel-major: over the LAST axis,
    with the biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class AcousticModel(nn.Module):
    """``args`` is a ``DelightfulTtsArgs``; ``num_mels`` the audio config's."""

    def __init__(self, args, num_mels: int = 100):
        super().__init__()
        a = self.args = args
        dim = self.emb_dim = a.n_hidden_conformer_encoder
        spk_dim = (a.d_vector_dim if a.use_d_vector_file
                   else (a.speaker_embedding_channels if a.use_speaker_embedding else 0))
        self.src_word_emb = EmbeddingPadded(a.num_chars, dim, getattr(a, "pad_id", 0))
        self.encoder = Conformer(dim, a.n_layers_conformer_encoder, a.n_heads_conformer_encoder,
                                 spk_dim, a.kernel_size_conv_mod_conformer_encoder, a.lrelu_slope)
        hidden, k = a.n_hidden_variance_adaptor, a.kernel_size_variance_adaptor
        self.pitch_adaptor = VarianceAdaptor(dim, hidden, k, a.emb_kernel_size_variance_adaptor,
                                             a.lrelu_slope)
        self.energy_adaptor = VarianceAdaptor(dim, hidden, k,
                                              a.emb_kernel_size_variance_adaptor, a.lrelu_slope,
                                              emb_features=hidden)
        self.duration_predictor = VariancePredictor(dim, hidden, 1, k, a.lrelu_slope)
        kp = a.predictor_kernel_size_reference_encoder
        self.utterance_prosody_predictor = PhonemeProsodyPredictor(
            dim, kp, a.bottleneck_size_u_reference_encoder, a.lrelu_slope)
        self.phoneme_prosody_predictor = PhonemeProsodyPredictor(
            dim, kp, a.bottleneck_size_p_reference_encoder, a.lrelu_slope)
        self.u_bottle_out = nn.Linear(a.bottleneck_size_u_reference_encoder, dim)
        self.p_bottle_out = nn.Linear(a.bottleneck_size_p_reference_encoder, dim)
        self.decoder = Conformer(a.n_hidden_conformer_decoder, a.n_layers_conformer_decoder,
                                 a.n_heads_conformer_decoder, spk_dim,
                                 a.kernel_size_conv_mod_conformer_decoder, a.lrelu_slope)
        self.to_mel = nn.Linear(a.n_hidden_conformer_decoder, num_mels)
        if a.use_speaker_embedding and a.num_speakers > 0:
            self.emb_g = nn.Embedding(a.num_speakers, a.speaker_embedding_channels)
        self._table: Optional[torch.Tensor] = None  # the positional table, outside the state

    def positions(self, length: int, device) -> torch.Tensor:
        """The first ``length`` rows of the positional table ``[1, length,
        C]`` on ``device``."""
        table = self._table
        if table is None or table.shape[0] < length or table.device != torch.device(device):
            size = max(length, 0 if table is None else table.shape[0])
            table = self._table = torch.from_numpy(positional_encoding(self.emb_dim, size)).to(
                device)
        return table[None, :length]

    def _speaker_embedding(self, d_vectors, speaker_idx):
        """L2-normalised d-vectors, else the normalised ``emb_g`` row of
        ``speaker_idx``, else ``None`` (reference ``acoustic_model.py:330``)."""
        if d_vectors is not None:
            e = d_vectors
        elif speaker_idx is not None and hasattr(self, "emb_g"):
            e = self.emb_g(speaker_idx)
        else:
            return None
        return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-12)

    @staticmethod
    def _expand_with_durations(o_en, dr, src_mask, y_mask):
        """``[B, T_en, C]`` and durations → ``[B, T_de, C]`` and the
        alignments ``[B, T_de, T_en]`` (reference
        ``_expand_encoder_with_durations``)."""
        attn_mask = (~src_mask)[:, :, None].float() * y_mask[:, None, :]
        attn = generate_path(dr, attn_mask)
        return torch.einsum("bxy,bxc->byc", attn, o_en), attn.transpose(1, 2)

    def inference(self, tokens, src_lens=None, d_vectors=None, speaker_idx=None,
                  max_frames: int = 1000, d_control: float = 1.0) -> Dict[str, torch.Tensor]:
        """Token ids ``[B, T_en]`` → mel ``[B, max_frames, num_mels]`` (zero
        after each row's ``y_lengths``) with the durations, alignments and
        the predicted pitch and energy."""
        B, T = tokens.shape
        if src_lens is None:
            src_lens = torch.full((B,), T, device=tokens.device)
        src_mask = ~sequence_mask(src_lens, T)
        token_emb = self.src_word_emb(tokens).masked_fill(src_mask[:, :, None], 0.0)
        speaker_embedding = self._speaker_embedding(d_vectors, speaker_idx)
        pos = self.positions(max(T, max_frames), tokens.device)

        o_en = self.encoder(token_emb, src_mask, speaker_embedding, pos)
        u_raw = self.utterance_prosody_predictor(o_en, src_mask)
        lengths = (~src_mask).float().sum(1)
        u_pred = _norm_last(u_raw.sum(1, keepdim=True) / lengths[:, None, None])
        o_en = o_en + self.u_bottle_out(u_pred)
        p_pred = _norm_last(self.phoneme_prosody_predictor(o_en, src_mask))
        o_en = o_en + self.p_bottle_out(p_pred)

        o_en_res = o_en
        pitch_emb, pitch_pred = self.pitch_adaptor.embedding_infer(o_en, src_mask)
        energy_emb, energy_pred = self.energy_adaptor.embedding_infer(o_en, src_mask)
        o_en = o_en + pitch_emb + energy_emb

        valid = (~src_mask).float()
        log_dr = self.duration_predictor(o_en_res, src_mask)
        dr = (torch.exp(log_dr) - 1) * valid * self.args.length_scale * d_control
        dr = torch.round(torch.clamp(dr, min=1.0)) * valid
        mel_lens = torch.clamp(dr.sum(1), 1, max_frames).long()
        y_mask = sequence_mask(mel_lens, max_frames).float()
        o_ex, alignments = self._expand_with_durations(o_en, dr, src_mask, y_mask)
        x = self.decoder(o_ex, y_mask < 0.5, speaker_embedding, pos)
        return {"model_outputs": self.to_mel(x) * y_mask[:, :, None], "durations": dr,
                "y_lengths": mel_lens, "alignments": alignments, "pitch": pitch_pred,
                "energy": energy_pred}
