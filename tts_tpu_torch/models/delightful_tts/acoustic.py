"""DelightfulTTS acoustic layers, the inference parts (port of
``tts_tpu/models/delightful_tts/acoustic.py``, reference
``TTS/tts/layers/delightful_tts/*``): the sinusoidal table, ``BSConv1d``,
``ConvTransposed``, ``Conv1dGLU`` (speaker conditioning), the conformer's
``FeedForward`` and ``ConformerConvModule``, ``RelativeMultiHeadAttention``
with ``_relative_shift``, ``ConformerMultiHeadedSelfAttention``,
``ConformerBlock``, ``Conformer``, ``VariancePredictor``, ``VarianceAdaptor``
(its inference embedding), ``PhonemeProsodyPredictor`` and
``EmbeddingPadded``.

Values are time-major ``[B, T, C]`` as in the JAX package; each convolution
moves to channel-first and back. Masks are ``True`` on padded positions
(the reference's ``get_mask_from_lengths``). The reference's quirks stay,
since the outputs depend on them: the feed-forward's 0.5 output scale, the
group norm over time and channels of padded frames too, the absolute
sinusoidal table fed as the "relative" positions, the ``-1e9`` fill of
masked scores. Module and parameter names follow the flax modules', so that
``utils.convert.delightful_tts_from_jax_params`` maps the JAX parameters
by the generic rules; ``EmbeddingPadded`` keeps flax's ``embeddings``.

The reference encoder, the style-token layer and the two prosody encoders
read mels and serve training; they wait for it (ROADMAP.md item 17).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LAYER_NORM_EPS = 1e-5  # the reference's torch default, kept by the JAX package


def positional_encoding(d_model: int, length: int) -> np.ndarray:
    """The sinusoidal table ``[length, d_model]`` (reference
    ``networks.py:18``): sin on even channels, cos on odd ones. Built on the
    host in numpy with the JAX package's float32 arithmetic, so that it
    equals the JAX package's table bit for bit; row ``t`` does not depend
    on ``length``."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class BSConv1d(nn.Module):
    """Pointwise then depthwise convolution (reference ``conv_layers.py:224``)
    on channel-first ``[B, C, T]``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, padding: int):
        super().__init__()
        self.pointwise = nn.Conv1d(in_channels, features, 1)
        self.depthwise = nn.Conv1d(features, features, kernel_size, padding=padding,
                                   groups=features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.depthwise(self.pointwise(x))


class ConvTransposed(nn.Module):
    """``BSConv1d`` over the time axis of ``[B, T, C]`` (reference
    ``conv_layers.py:291``: the name refers to its transposing wrapper)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1, padding: int = 0):
        super().__init__()
        self.conv = BSConv1d(in_channels, features, kernel_size, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class Conv1dGLU(nn.Module):
    """Gated convolution conditioned on a speaker embedding (reference
    ``conv_layers.py:264``): ``(a + softsign(proj(e))) · sigmoid(b)`` plus
    the input, times ``sqrt(0.5)``."""

    def __init__(self, d_model: int, kernel_size: int, embedding_dim: int):
        super().__init__()
        self.conv = BSConv1d(d_model, 2 * d_model, kernel_size, kernel_size // 2)
        self.embedding_proj = nn.Linear(embedding_dim, d_model)

    def forward(self, x: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
        a, b = self.conv(x.transpose(1, 2)).transpose(1, 2).chunk(2, dim=-1)
        a = a + F.softsign(self.embedding_proj(embeddings))[:, None, :]
        return (a * torch.sigmoid(b) + x) * math.sqrt(0.5)


class FeedForward(nn.Module):
    """The conformer's feed-forward module with its 0.5 output scale
    (reference ``conformer.py:178``)."""

    def __init__(self, d_model: int, kernel_size: int, lrelu_slope: float,
                 expansion_factor: int = 4):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.ln = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.conv_1 = nn.Conv1d(d_model, d_model * expansion_factor, kernel_size,
                                padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(d_model * expansion_factor, d_model, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv_1(self.ln(x).transpose(1, 2)), self.lrelu_slope)
        return 0.5 * self.conv_2(x).transpose(1, 2)


class ConformerConvModule(nn.Module):
    """GLU-gated depthwise convolution module (reference
    ``conformer.py:233``); ``ln_2`` is a one-group norm over time and
    channels."""

    def __init__(self, d_model: int, kernel_size: int = 7, expansion_factor: int = 2,
                 lrelu_slope: float = 0.3):
        super().__init__()
        inner = d_model * expansion_factor
        self.lrelu_slope = lrelu_slope
        self.ln_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.conv_1 = nn.Conv1d(d_model, inner * 2, 1)
        self.depthwise = nn.Conv1d(inner, inner, kernel_size, padding=kernel_size // 2,
                                   groups=inner)
        self.ln_2 = nn.GroupNorm(1, inner, eps=LAYER_NORM_EPS)
        self.conv_2 = nn.Conv1d(inner, d_model, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gate = self.conv_1(self.ln_1(x).transpose(1, 2)).chunk(2, dim=1)
        x = self.depthwise(out * F.leaky_relu(gate, self.lrelu_slope))
        x = F.leaky_relu(self.ln_2(x), self.lrelu_slope)
        return self.conv_2(x).transpose(1, 2)


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL style attention with content and position biases
    (reference ``conformer.py:334``)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        head = d_model // num_heads
        self.query_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model, bias=False)
        self.value_proj = nn.Linear(d_model, d_model, bias=False)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, head))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, head))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, pos_embedding, mask):
        """``mask`` broadcasts to the scores ``[B, H, T_q, T_k]``, ``True``
        where a score is dropped."""
        B = query.shape[0]
        H, dh = self.num_heads, self.d_model // self.num_heads
        q = self.query_proj(query).view(B, -1, H, dh)
        k = self.key_proj(key).view(B, -1, H, dh)
        v = self.value_proj(value).view(B, -1, H, dh)
        p = self.pos_proj(pos_embedding).view(B, -1, H, dh)
        content = torch.einsum("bthd,bshd->bhts", q + self.u_bias, k)
        pos = self._relative_shift(torch.einsum("bthd,bshd->bhts", q + self.v_bias, p))
        score = ((content + pos) / math.sqrt(self.d_model)).masked_fill(mask, -1e9)
        attn = torch.softmax(score, dim=-1)
        ctx = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, -1, self.d_model)
        return self.out_proj(ctx), attn

    @staticmethod
    def _relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
        """Pad one zero column on the left, read the ``[T1, T2 + 1]`` block
        as ``[T2 + 1, T1]``, drop its first row and read it back as
        ``[T1, T2]`` (reference ``conformer.py:376``)."""
        B, H, T1, T2 = pos_score.shape
        padded = F.pad(pos_score, (1, 0)).view(B, H, T2 + 1, T1)
        return padded[:, :, 1:].reshape(B, H, T1, T2)


class ConformerMultiHeadedSelfAttention(nn.Module):
    """(reference ``conformer.py:295``): the table's first ``T_k`` rows as
    the position embedding."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = RelativeMultiHeadAttention(d_model, num_heads)

    def forward(self, query, key, value, mask, encoding):
        B, T = key.shape[0], key.shape[1]
        enc = encoding[:, :T].expand(B, T, encoding.shape[-1])
        return self.attention(query, key, value, enc, mask)


class ConformerBlock(nn.Module):
    """(reference ``conformer.py:94``): speaker conditioning when the model
    has speakers, feed-forward, convolution module, self-attention, padded
    frames zeroed, convolution module; each with its residual."""

    def __init__(self, d_model: int, n_head: int, kernel_size_conv_mod: int,
                 speaker_embedding_dim: int, lrelu_slope: float = 0.3):
        super().__init__()
        if speaker_embedding_dim:
            self.conditioning = Conv1dGLU(d_model, kernel_size_conv_mod, speaker_embedding_dim)
        self.ff = FeedForward(d_model, 3, lrelu_slope)
        self.conformer_conv_1 = ConformerConvModule(d_model, kernel_size_conv_mod,
                                                    lrelu_slope=lrelu_slope)
        self.ln = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.slf_attn = ConformerMultiHeadedSelfAttention(d_model, n_head)
        self.conformer_conv_2 = ConformerConvModule(d_model, kernel_size_conv_mod,
                                                    lrelu_slope=lrelu_slope)

    def forward(self, x, mask, slf_attn_mask, speaker_embedding, encoding):
        if speaker_embedding is not None:
            x = self.conditioning(x, speaker_embedding)
        x = self.ff(x) + x
        x = self.conformer_conv_1(x) + x
        y = self.ln(x)
        x = self.slf_attn(y, y, y, slf_attn_mask, encoding)[0] + x
        x = x.masked_fill(mask[:, :, None], 0.0)
        return self.conformer_conv_2(x) + x


class Conformer(nn.Module):
    """``n_layers`` conformer blocks (``block_<i>``; reference
    ``conformer.py:18``); ``mask`` ``[B, T]`` is ``True`` on padded frames,
    whose keys every block's attention drops."""

    def __init__(self, dim: int, n_layers: int, n_heads: int, speaker_embedding_dim: int,
                 kernel_size_conv_mod: int, lrelu_slope: float):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", ConformerBlock(dim, n_heads, kernel_size_conv_mod,
                                                         speaker_embedding_dim, lrelu_slope))

    def forward(self, x, mask, speaker_embedding, encoding):
        attn_mask = mask[:, None, None, :]
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, mask, attn_mask, speaker_embedding, encoding)
        return x


class VariancePredictor(nn.Module):
    """Two ``ConvTransposed`` → leaky ReLU → layer norm stages and a linear
    output, zero on padded tokens (reference ``variance_predictor.py:7``)."""

    def __init__(self, in_channels: int, channels: int, channels_out: int, kernel_size: int,
                 lrelu_slope: float):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.channels_out = channels_out
        for i in range(2):
            self.add_module(f"conv_{i}", ConvTransposed(in_channels if i == 0 else channels,
                                                        channels, kernel_size,
                                                        (kernel_size - 1) // 2))
            self.add_module(f"ln_{i}", nn.LayerNorm(channels, eps=LAYER_NORM_EPS))
        self.linear_layer = nn.Linear(channels, channels_out)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), self.lrelu_slope)
            x = getattr(self, f"ln_{i}")(x)
        x = self.linear_layer(x)
        x = x[..., 0] if self.channels_out == 1 else x
        return x.masked_fill(mask, 0.0)


class VarianceAdaptor(nn.Module):
    """The pitch or energy adaptor (reference ``pitch_adaptor.py`` /
    ``energy_adaptor.py``), its inference path: the predicted value a token
    and its embedding by a convolution. The pitch adaptor's embedding has
    ``n_input`` channels, the energy adaptor's ``emb_features``
    (``n_hidden``), as in the reference."""

    def __init__(self, n_input: int, n_hidden: int, kernel_size: int, emb_kernel_size: int,
                 lrelu_slope: float, emb_features: Optional[int] = None):
        super().__init__()
        self.predictor = VariancePredictor(n_input, n_hidden, 1, kernel_size, lrelu_slope)
        self.emb = nn.Conv1d(1, emb_features or n_input, emb_kernel_size,
                             padding=(emb_kernel_size - 1) // 2)

    def embedding_infer(self, x: torch.Tensor, mask: torch.Tensor):
        """``(embedding [B, T, C], prediction [B, T])``."""
        pred = self.predictor(x, mask)
        return self.emb(pred[:, None, :]).transpose(1, 2), pred


class PhonemeProsodyPredictor(nn.Module):
    """(reference ``phoneme_prosody_predictor.py:7``): the variance
    predictor's two stages, padded tokens zeroed, then the bottleneck."""

    def __init__(self, hidden_size: int, kernel_size: int, bottleneck_size: int,
                 lrelu_slope: float):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        for i in range(2):
            self.add_module(f"conv_{i}", ConvTransposed(hidden_size, hidden_size, kernel_size,
                                                        (kernel_size - 1) // 2))
            self.add_module(f"ln_{i}", nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS))
        self.predictor_bottleneck = nn.Linear(hidden_size, bottleneck_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), self.lrelu_slope)
            x = getattr(self, f"ln_{i}")(x)
        return self.predictor_bottleneck(x.masked_fill(mask[:, :, None], 0.0))


class EmbeddingPadded(nn.Module):
    """Token embedding whose ``padding_idx`` row reads as zeros (reference
    ``networks.py:134``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, padding_idx: int):
        super().__init__()
        self.padding_idx = padding_idx
        self.embeddings = nn.Parameter(torch.zeros(num_embeddings, embedding_dim))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        table = self.embeddings.index_fill(0, torch.tensor([self.padding_idx],
                                                           device=idx.device), 0.0)
        return F.embedding(idx, table)
