"""Gaussian-attention alignment network of ForwardTTS and DelightfulTTS
training (port of ``tts_tpu/layers/aligner.py``, reference
``TTS/tts/layers/generic/aligner.py:7``).

Two convolution towers, one over the mel frames (queries) and one over the
token embeddings (keys), give ``-temperature · ‖q - k‖²`` for every
(frame, token) pair. The squared distance is expanded as the JAX package
expands it, ``‖q‖² - 2 q·k + ‖k‖²``. Tensors are time-major ``[B, T, C]``;
the towers run channel-first inside. Layer names follow the flax module's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv1d


class AlignmentNetwork(nn.Module):
    """Query (mel) and key (token) towers → ``-T·L2²`` log-attention."""

    def __init__(self, in_query_channels: int = 80, in_key_channels: int = 512,
                 attn_channels: int = 80, temperature: float = 0.0005):
        super().__init__()
        self.temperature = temperature
        self.key_conv1 = Conv1d(in_key_channels, in_key_channels * 2, 3)
        self.key_conv2 = Conv1d(in_key_channels * 2, attn_channels, 1)
        self.query_conv1 = Conv1d(in_query_channels, in_query_channels * 2, 3)
        self.query_conv2 = Conv1d(in_query_channels * 2, in_query_channels, 1)
        self.query_conv3 = Conv1d(in_query_channels, attn_channels, 1)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``queries [B, T_de, C_q]``, ``keys [B, T_en, C_k]``; ``mask [B,
        T_de]`` (1 on valid frames), ``attn_prior [B, T_de, T_en]``,
        ``key_mask [B, T_en]`` (1 on valid tokens; the masked keys get -inf
        after the prior, before the softmax, as DelightfulTTS's reference
        does). Returns ``(attn, attn_logp)``, both ``[B, T_de, T_en]``,
        ``attn`` softmaxed over the tokens."""
        k = self.key_conv2(F.relu(self.key_conv1(keys.transpose(1, 2)))).transpose(1, 2)
        q = F.relu(self.query_conv1(queries.transpose(1, 2)))
        q = F.relu(self.query_conv2(q))
        q = self.query_conv3(q).transpose(1, 2)
        dist = (torch.sum(q**2, -1)[:, :, None]
                - 2.0 * torch.einsum("bqc,bkc->bqk", q, k)
                + torch.sum(k**2, -1)[:, None, :])
        attn_logp = -self.temperature * dist
        if attn_prior is not None:
            attn_logp = torch.log_softmax(attn_logp, dim=-1) + torch.log(attn_prior + 1e-8)
        if key_mask is not None:
            attn_logp = attn_logp.masked_fill(key_mask[:, None, :] <= 0, float("-inf"))
        attn = torch.softmax(attn_logp, dim=-1)
        if mask is not None:
            attn = attn * mask[:, :, None]
        return attn, attn_logp
