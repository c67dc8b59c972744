"""Tacotron v1 layers and global style tokens (port of
``tts_tpu/layers/tacotron_v1.py``, reference
``TTS/tts/layers/tacotron/{tacotron,gst_layers}.py``), inference only:
``Highway``, ``CBHG`` (conv bank, max-pool, projections, highways and a
biGRU), and ``ReferenceEncoder``, ``StyleTokenLayer`` and ``GST``.

Values are time-major ``[B, T, C]``, as in the JAX package. Module and
parameter names are the flax ones, so that
``utils.convert.tacotron_from_jax_params`` maps most leaves by the generic
rules; the GRUs are torch's ``nn.GRU`` (flax's ``GRUCell`` puts no bias on
the hidden side of ``r`` and ``z`` and one on ``n``, which the converter
packs into ``bias_ih``/``bias_hh``). The CBHG's biGRU runs over a packed
batch, so that its backward direction starts at each row's true end, as
``seq_lengths`` makes the JAX one's. Layer norms take flax's epsilon, 1e-6.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

REFERENCE_CHANNELS = (32, 32, 64, 64, 128, 128)  # the six 3x3 stride-2 convolutions
NEG = -1e9  # what the CBHG pools over at padded positions


class NormConv1d(nn.Module):
    """Bias-free conv with padding ``((k - 1) // 2, k - 1 - (k - 1) // 2)``,
    optional ReLU, then layer norm (JAX ``_NormConv1d``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: bool = True):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2)
        self.activation = activation
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, bias=False)
        self.norm = nn.LayerNorm(out_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.pad(x.transpose(1, 2), self.pad)).transpose(1, 2)
        return self.norm(F.relu(x) if self.activation else x)


class Highway(nn.Module):
    """``relu(H x) · σ(T x) + x · (1 − σ(T x))``; the JAX package
    initialises ``T``'s bias to −1."""

    def __init__(self, features: int):
        super().__init__()
        self.H = nn.Linear(features, features)
        self.T = nn.Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(self.T(x))
        return F.relu(self.H(x)) * t + x * (1.0 - t)


class CBHG(nn.Module):
    """Conv bank + highway + biGRU (reference ``tacotron.py:94``), under a
    frame mask ``x_mask`` ``[B, T, 1]``: the conv stages are re-zeroed at
    padded positions, the max-pool sees −1e9 there (so the last valid
    position pools as at an unpadded edge), and the biGRU runs over each
    row's valid frames only. Valid outputs therefore do not depend on the
    padding after them."""

    def __init__(self, in_channels: int, K: int = 16, conv_bank_features: int = 128,
                 conv_projections: Sequence[int] = (128, 128), highway_features: int = 128,
                 gru_features: int = 128, num_highways: int = 4):
        super().__init__()
        self.K, self.num_highways = K, num_highways
        self.n_proj = len(conv_projections)
        for k in range(1, K + 1):
            self.add_module(f"bank_{k}", NormConv1d(in_channels, conv_bank_features, k))
        sizes = (K * conv_bank_features,) + tuple(conv_projections)
        for i in range(self.n_proj):
            self.add_module(f"proj_{i}", NormConv1d(sizes[i], sizes[i + 1], 3,
                                                    activation=i < self.n_proj - 1))
        if conv_projections[-1] != highway_features:
            self.pre_highway = nn.Linear(conv_projections[-1], highway_features)
        for i in range(num_highways):
            self.add_module(f"highway_{i}", Highway(highway_features))
        self.gru = nn.GRU(highway_features, gru_features, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x = x * x_mask
        h = torch.cat([getattr(self, f"bank_{k}")(x) for k in range(1, self.K + 1)], dim=-1)
        h = torch.where(x_mask > 0, h, torch.full_like(h, NEG))
        h = F.max_pool1d(F.pad(h.transpose(1, 2), (0, 1), value=NEG), 2, 1).transpose(1, 2)
        h = h * x_mask
        for i in range(self.n_proj):
            h = getattr(self, f"proj_{i}")(h) * x_mask
        h = h + x
        if hasattr(self, "pre_highway"):
            h = self.pre_highway(h)
        for i in range(self.num_highways):
            h = getattr(self, f"highway_{i}")(h)
        lengths = x_mask[:, :, 0].sum(1).long().cpu()
        packed = pack_padded_sequence(h, lengths, batch_first=True, enforce_sorted=False)
        out, _ = pad_packed_sequence(self.gru(packed)[0], batch_first=True,
                                     total_length=h.shape[1])
        return out


def add_ref_convs(module: nn.Module, norm_type: str, padding: int) -> None:
    """The six 3x3 stride-2 convolutions of a reference encoder, each
    followed by a layer norm (``norm_i``) or the folded affine of an
    eval-mode BatchNorm (``scale_i``, ``shift_i``)."""
    if norm_type not in ("layer", "folded"):
        raise ValueError(f"norm_type {norm_type!r}: 'layer' or 'folded'")
    module.norm_type = norm_type
    for i, ch in enumerate(REFERENCE_CHANNELS):
        module.add_module(f"conv_{i}", nn.Conv2d(REFERENCE_CHANNELS[i - 1] if i else 1, ch, 3,
                                                 stride=2, padding=padding))
        if norm_type == "folded":
            module.register_parameter(f"scale_{i}", nn.Parameter(torch.ones(ch)))
            module.register_parameter(f"shift_{i}", nn.Parameter(torch.zeros(ch)))
        else:
            module.add_module(f"norm_{i}", nn.LayerNorm(ch, eps=1e-6))


def ref_conv_step(module: nn.Module, i: int, h: torch.Tensor) -> torch.Tensor:
    """Conv ``i`` of a reference encoder on ``[B, C, T, M]``, its norm over
    the channels, then ReLU."""
    h = getattr(module, f"conv_{i}")(h).permute(0, 2, 3, 1)  # [B, T, M, C]
    if module.norm_type == "folded":
        h = h * getattr(module, f"scale_{i}") + getattr(module, f"shift_{i}")
    else:
        h = getattr(module, f"norm_{i}")(h)
    return F.relu(h).permute(0, 3, 1, 2)


def ref_flatten(h: torch.Tensor) -> torch.Tensor:
    """``[B, C, T, M]`` → ``[B, T, C·M]``, channel-major as the reference
    flattens (``x.transpose(1, 2).view(B, T, C * M)``)."""
    B, C, T, M = h.shape
    return h.permute(0, 2, 1, 3).reshape(B, T, C * M)


def ref_flat_width(num_mel: int, padding: int) -> int:
    """The flattened width after the six convolutions on ``num_mel`` bins."""
    m = num_mel
    for _ in REFERENCE_CHANNELS:
        m = (m + 2 * padding - 3) // 2 + 1
    return REFERENCE_CHANNELS[-1] * m


class ReferenceEncoder(nn.Module):
    """Mel ``[B, T, M]`` → style query ``[B, embedding_dim // 2]``
    (reference ``gst_layers.py:26``): six 3x3 stride-2 convolutions
    (padding 1), the channel-major flatten and a GRU whose last step is the
    query."""

    def __init__(self, num_mel: int, embedding_dim: int, norm_type: str = "layer"):
        super().__init__()
        add_ref_convs(self, norm_type, padding=1)
        self.gru = nn.GRU(ref_flat_width(num_mel, 1), embedding_dim // 2, batch_first=True)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = mel[:, None]
        for i in range(len(REFERENCE_CHANNELS)):
            h = ref_conv_step(self, i, h)
        return self.gru(ref_flatten(h))[0][:, -1]


class StyleTokenLayer(nn.Module):
    """Multi-head attention of the query over ``tanh`` of the learned style
    tokens, scores scaled by ``1/√d`` (reference ``gst_layers.py:82``)."""

    def __init__(self, query_dim: int, num_heads: int, num_style_tokens: int,
                 gst_embedding_dim: int):
        super().__init__()
        self.num_heads = num_heads
        key_dim = gst_embedding_dim // num_heads
        self.style_tokens = nn.Parameter(torch.zeros(num_style_tokens, key_dim))
        self.W_query = nn.Linear(query_dim, gst_embedding_dim, bias=False)
        self.W_key = nn.Linear(key_dim, gst_embedding_dim, bias=False)
        self.W_value = nn.Linear(key_dim, gst_embedding_dim, bias=False)

    def forward(self, query: torch.Tensor) -> torch.Tensor:
        keys = torch.tanh(self.style_tokens)  # [N, key]
        B, H = query.shape[0], self.num_heads
        q = self.W_query(query).view(B, H, -1)  # [B, H, d]
        k = self.W_key(keys).view(keys.shape[0], H, -1)  # [N, H, d]
        v = self.W_value(keys).view(keys.shape[0], H, -1)
        scores = torch.einsum("bhd,nhd->bhn", q, k) / q.shape[-1] ** 0.5
        return torch.einsum("bhn,nhd->bhd", torch.softmax(scores, dim=-1), v).reshape(B, -1)


class GST(nn.Module):
    """Global style tokens (reference ``gst_layers.py:6``): a style mel
    ``[B, T, num_mel]`` → style vector ``[B, gst_embedding_dim]``."""

    def __init__(self, num_mel: int, num_heads: int, num_style_tokens: int,
                 gst_embedding_dim: int, norm_type: str = "layer"):
        super().__init__()
        self.encoder = ReferenceEncoder(num_mel, gst_embedding_dim, norm_type)
        self.style_token_layer = StyleTokenLayer(gst_embedding_dim // 2, num_heads,
                                                 num_style_tokens, gst_embedding_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.style_token_layer(self.encoder(mel))
