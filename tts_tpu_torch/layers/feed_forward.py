"""Feed-forward (non-autoregressive) encoder and decoder blocks of the
ForwardTTS family (port of ``tts_tpu/layers/feed_forward.py``, reference
``TTS/tts/layers/generic/{transformer,res_conv_bn,pos_encoding}.py``). The
FFT layers carry the JAX package's dropouts (on the attention weights, on
the attention output's first copy, on the feed-forward's output), which act
in training mode only (``layers.common.Dropout``). Every block takes and returns a time-major
``[B, T, C]`` tensor, the JAX package's layout, with a ``[B, T, 1]`` mask of
ones on valid frames.

Kept from the JAX package, since the outputs depend on them:

* ``FFTransformerLayer`` adds the attention output twice (the reference adds
  it once through dropout and once raw) and zeroes the pad rows before each
  of its two convolutions;
* attention masks the padded keys only; a padded query row attends like any
  other and ``FFTransformerBlock`` zeroes it after each layer. A row whose
  keys are all masked gets a finite uniform average (the masked scores are
  the dtype's lowest value, as flax fills them), not NaN;
* ``ResidualConv1dBNBlock`` normalises with LayerNorm where the reference
  has BatchNorm, and pads an even kernel unevenly (the extra tap on the
  right), so that every convolution keeps the length;
* ``PositionalEncoding``'s table is the reference's: ``sin``/``cos`` of
  ``position × 10000^(2i/C)`` (multiplied, not divided), built in float64
  numpy and cast to float32 once, since its arguments reach the tens of
  millions, where a float32 ``torch.sin`` gives another table; the input
  is scaled by ``sqrt(C)``.

Norms are flax's ``LayerNorm`` (epsilon 1e-6). The attention keeps
``nn.MultiheadAttention``'s parameter layout (``in_proj_weight`` ``[3C, C]``,
``in_proj_bias``, ``out_proj``), the reference checkpoint's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv1d, Dropout

FLAX_LAYER_NORM_EPS = 1e-6


class SelfAttention(nn.Module):
    """Multi-head self-attention over ``[B, T, C]`` with ``key_padding_mask``
    ``[B, T]`` (True on padded keys)."""

    def __init__(self, channels: int, num_heads: int, dropout_p: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * channels))
        self.out_proj = nn.Linear(channels, channels)
        self.dropout = Dropout(dropout_p)  # on the attention weights, as flax's

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        B, T, C = x.shape
        dh = C // self.num_heads

        def heads(t):
            return t.view(B, T, self.num_heads, dh).transpose(1, 2)  # [B, H, T, dh]

        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        scores = (heads(q) / math.sqrt(dh)) @ heads(k).transpose(-1, -2)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        out = self.dropout(torch.softmax(scores, dim=-1)) @ heads(v)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))


class FFTransformerLayer(nn.Module):
    """Self-attention and a two-conv feed-forward, each followed by a
    residual LayerNorm (reference ``generic/transformer.py:6``)."""

    def __init__(self, channels: int, num_heads: int, hidden_channels_ffn: int = 1024,
                 kernel_size_fft: int = 3, dropout_p: float = 0.0):
        super().__init__()
        self.self_attn = SelfAttention(channels, num_heads, dropout_p)
        self.dropout = Dropout(dropout_p)
        self.norm1 = nn.LayerNorm(channels, eps=FLAX_LAYER_NORM_EPS)
        self.conv1 = Conv1d(channels, hidden_channels_ffn, kernel_size_fft)
        self.conv2 = Conv1d(hidden_channels_ffn, channels, kernel_size_fft)
        self.norm2 = nn.LayerNorm(channels, eps=FLAX_LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        y = self.self_attn(x, key_padding_mask)
        # the attention output twice, once through dropout, as the JAX package adds it
        x = self.norm1(x + self.dropout(y) + y)
        pad = None if key_padding_mask is None else key_padding_mask[:, :, None]
        if pad is not None:
            x = x.masked_fill(pad, 0.0)
        y = F.relu(self.conv1(x.transpose(1, 2))).transpose(1, 2)
        if pad is not None:
            y = y.masked_fill(pad, 0.0)
        y = self.dropout(self.conv2(y.transpose(1, 2)).transpose(1, 2))
        return self.norm2(x + y)


class FFTransformerBlock(nn.Module):
    """``num_layers`` FFT layers (``fft_<i>``), the output masked after each
    (reference ``generic/transformer.py:38``)."""

    def __init__(self, channels: int, num_heads: int, hidden_channels_ffn: int,
                 num_layers: int, dropout_p: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fft_{i}", FFTransformerLayer(channels, num_heads,
                                                           hidden_channels_ffn,
                                                           dropout_p=dropout_p))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        key_padding_mask = None if mask is None else mask[..., 0] < 0.5
        for i in range(self.num_layers):
            x = getattr(self, f"fft_{i}")(x, key_padding_mask)
            if mask is not None:
                x = x * mask
        return x


class ResidualConv1dBNBlock(nn.Module):
    """Dilated conv stacks with residuals (reference
    ``generic/res_conv_bn.py``, the SpeedySpeech encoder and decoder): for
    each dilation ``num_conv_blocks`` × (conv → LayerNorm → ReLU), the first
    stack's output alone and every later one's added to the one before;
    then the 1x1 projection ``proj``."""

    def __init__(self, hidden_channels: int, out_channels: int, kernel_size: int,
                 dilations: Sequence[int], num_conv_blocks: int = 2):
        super().__init__()
        self.dilations = tuple(dilations)
        self.num_conv_blocks = num_conv_blocks
        self.kernel_size = kernel_size
        for b, d in enumerate(self.dilations):
            for c in range(num_conv_blocks):
                self.add_module(f"block{b}_conv{c}", nn.Conv1d(hidden_channels, hidden_channels,
                                                               kernel_size, dilation=d))
                self.add_module(f"block{b}_norm{c}", nn.LayerNorm(hidden_channels,
                                                                  eps=FLAX_LAYER_NORM_EPS))
        self.proj = Conv1d(hidden_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None):
        if x_mask is None:
            x_mask = torch.ones_like(x[..., :1])
        mask = x_mask.transpose(1, 2)
        x = x.transpose(1, 2)  # [B, C, T]
        res = None
        for b, d in enumerate(self.dilations):
            total = d * (self.kernel_size - 1)
            h = x
            for c in range(self.num_conv_blocks):
                h = F.pad(h * mask, (total // 2, total - total // 2))
                h = getattr(self, f"block{b}_conv{c}")(h)
                h = F.relu(getattr(self, f"block{b}_norm{c}")(h.transpose(1, 2)).transpose(1, 2))
            x = h if res is None else h + res
            res = x
        return (self.proj(x * mask) * mask).transpose(1, 2)


def sinusoid_table(channels: int, max_len: int = 5000) -> np.ndarray:
    """The reference's ``[max_len, channels]`` table, float64 arithmetic,
    float32 result."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.power(10000.0, np.arange(0, channels, 2, dtype=np.float64) / channels)
    pe = np.zeros((max_len, channels), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : channels // 2]
    return pe


class PositionalEncoding(nn.Module):
    """``x · sqrt(C)`` plus the masked table (times a learned scale with
    ``use_scale``: ``weight``, flax's and the reference's ``scale``). The
    table is a buffer outside the state_dict."""

    def __init__(self, channels: int, use_scale: bool = False, max_len: int = 5000):
        super().__init__()
        self.channels = channels
        if use_scale:
            self.weight = nn.Parameter(torch.ones(1))
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(channels, max_len)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        pe = self.pe[None, : x.shape[1]]
        if mask is not None:
            pe = pe * mask
        x = x * math.sqrt(self.channels)
        if hasattr(self, "weight"):
            return x + self.weight * pe
        return x + pe
