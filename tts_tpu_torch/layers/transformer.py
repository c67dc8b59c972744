"""Relative-position transformer (port of ``tts_tpu/layers/transformer.py``)
as the VITS text encoder uses it: self-attention with relative-position
tables shared across heads, output width equal to the input's, inference
only. Time-major ``[B, T, C]`` like the JAX package; the feed-forward convs
run channel-first inside.

The relative ↔ absolute position reshapes are the JAX package's, pad for
pad and reshape for reshape.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv1d, LayerNorm


def _relative_position_to_absolute_position(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, 2T-1]`` rel-indexed logits → ``[B, H, T, T]`` abs-indexed
    (reference ``transformer.py:206``)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))  # [B,H,T,2T]
    x_flat = x.reshape(b, h, t * 2 * t)
    x_flat = F.pad(x_flat, (0, t - 1))
    return x_flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1 :]


def _absolute_position_to_relative_position(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, T]`` → ``[B, H, T, 2T-1]`` (reference ``transformer.py:221``)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x_flat = x.reshape(b, h, t * t + t * (t - 1))
    x_flat = F.pad(x_flat, (t, 0))
    return x_flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


class RelativePositionMultiHeadAttention(nn.Module):
    """Self-attention with learned relative-position key/value embeddings
    over a ±window (reference ``transformer.py:10``)."""

    def __init__(self, channels: int, num_heads: int, rel_attn_window_size: int):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.k_channels = channels // num_heads
        self.window = rel_attn_window_size
        self.conv_q = nn.Linear(channels, channels)
        self.conv_k = nn.Linear(channels, channels)
        self.conv_v = nn.Linear(channels, channels)
        self.conv_o = nn.Linear(channels, channels)
        shape = (1, 2 * rel_attn_window_size + 1, self.k_channels)  # shared by the heads
        self.emb_rel_k = nn.Parameter(torch.randn(shape) * self.k_channels**-0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(shape) * self.k_channels**-0.5)

    def _get_relative_embeddings(self, emb: torch.Tensor, length: int) -> torch.Tensor:
        """Slice/pad the ``[1, 2W+1, d]`` table to ``[H, 2T-1, d]``."""
        pad_length = max(length - (self.window + 1), 0)
        if pad_length > 0:
            emb = F.pad(emb, (0, 0, pad_length, pad_length))
        start = max((self.window + 1) - length, 0)
        return emb[:, start : start + 2 * length - 1].expand(self.num_heads, -1, -1)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """x ``[B, T, C]``; attn_mask ``[B, 1, T, T]``."""
        B, T, _ = x.shape
        H, d = self.num_heads, self.k_channels
        q = self.conv_q(x).reshape(B, T, H, d)
        k = self.conv_k(x).reshape(B, T, H, d)
        v = self.conv_v(x).reshape(B, T, H, d)

        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
        key_rel = self._get_relative_embeddings(self.emb_rel_k, T)  # [H, 2T-1, d]
        rel_logits = torch.einsum("bthd,hmd->bhtm", q, key_rel)
        scores = scores + _relative_position_to_absolute_position(rel_logits) / math.sqrt(d)
        scores = scores.masked_fill(attn_mask == 0, -1e4)

        p_attn = torch.softmax(scores, dim=-1)  # [B, H, T, T]
        out = torch.einsum("bhts,bshd->bthd", p_attn, v)
        rel_weights = _absolute_position_to_relative_position(p_attn)  # [B, H, T, 2T-1]
        value_rel = self._get_relative_embeddings(self.emb_rel_v, T)
        out = out + torch.einsum("bhtm,hmd->bthd", rel_weights, value_rel)
        return self.conv_o(out.reshape(B, T, self.channels))


class FeedForwardNetwork(nn.Module):
    """Conv feed-forward block (reference ``transformer.py:260``)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int):
        super().__init__()
        self.conv_1 = Conv1d(channels, hidden_channels, kernel_size)
        self.conv_2 = Conv1d(hidden_channels, channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x, mask = x.transpose(1, 2), x_mask.transpose(1, 2)  # [B, C, T]
        x = F.relu(self.conv_1(x * mask))
        return (self.conv_2(x * mask) * mask).transpose(1, 2)


class RelativePositionTransformer(nn.Module):
    """Transformer encoder stack with relative positional encoding
    (reference ``transformer.py:432``). ``x`` ``[B, T, C]``, ``x_mask``
    ``[B, T, 1]``."""

    def __init__(self, hidden_channels: int, hidden_channels_ffn: int, num_heads: int,
                 num_layers: int, kernel_size: int, rel_attn_window_size: int):
        super().__init__()
        self.attn = nn.ModuleList(
            RelativePositionMultiHeadAttention(hidden_channels, num_heads, rel_attn_window_size)
            for _ in range(num_layers)
        )
        self.norm1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(num_layers))
        self.ffn = nn.ModuleList(
            FeedForwardNetwork(hidden_channels, hidden_channels_ffn, kernel_size)
            for _ in range(num_layers)
        )
        self.norm2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        attn_mask = x_mask[:, None, :, 0:1] * x_mask[:, None, None, :, 0]  # [B, 1, T, T]
        for attn, norm1, ffn, norm2 in zip(self.attn, self.norm1, self.ffn, self.norm2):
            x = x * x_mask
            x = norm1(x + attn(x, attn_mask))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask
