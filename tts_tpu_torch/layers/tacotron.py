"""Tacotron2 building blocks (port of ``tts_tpu/layers/tacotron.py``, reference
``TTS/tts/layers/tacotron/{tacotron2,attentions,common_layers}.py``),
inference only: ``Prenet``, ``ConvBNBlock``, ``Tacotron2Encoder``,
``Postnet`` and ``Tacotron2DecoderCell``, one step of the autoregressive
decoder. The JAX package scans the cell over a static number of steps; the
port's host loops over it (``models/tacotron2/model.py``).

Values are time-major ``[B, T, C]``, as in the JAX package; each conv moves
to channel-first and back. Module and parameter names are the flax ones, so
that ``utils.convert.tacotron2_from_jax_params`` maps most leaves by the
generic rules. The LSTMs are torch's: the encoder's biLSTM is one
``nn.LSTM`` over a packed batch, so that the backward direction starts at
each row's true end, as ``seq_lengths`` makes the JAX encoder's; the
decoder's two LSTMs are ``nn.LSTMCell``. Flax's ``OptimizedLSTMCell`` keeps
eight Denses (``ii/if/ig/io`` without bias, ``hi/hf/hg/ho`` with bias; gates
i, f, g, o), which the converter packs into ``weight_ih``/``weight_hh`` with
the bias on the hidden side.

No dropout runs at inference but the decoder prenet's, and only when the
config asks for it (``prenet_dropout_at_inference``); its mask is drawn from
the ``torch.Generator`` the caller passes. The JAX package never passes that
flag to its prenet, so it decodes deterministically whatever the config says
(ROADMAP.md F19). ``separate_stopnet`` only stops gradients and has no
effect here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .common import Conv1d

DCA_FILTERS, DCA_KERNEL = 8, 21  # dynamic convolution attention (reference attentions.py:472-481)


def _betabinom_pmf(n: int, a: float, b: float) -> np.ndarray:
    """Beta-binomial pmf over k=0..n (the DCA alignment prior, reference
    ``attentions.py:388`` via scipy.stats.betabinom)."""

    def log_beta(x, y):
        return math.lgamma(x) + math.lgamma(y) - math.lgamma(x + y)

    logp = [
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
        + log_beta(k + a, n - k + b) - log_beta(a, b)
        for k in range(n + 1)
    ]
    return np.exp(np.asarray(logp, np.float64)).astype(np.float32)


class Prenet(nn.Module):
    """Bottleneck MLP (reference ``common_layers.py`` Prenet): per layer
    linear → (layer norm for ``prenet_type="bn"``) → ReLU → dropout, the
    dropout only with ``prenet_dropout`` and ``dropout_at_inference``."""

    def __init__(self, in_features: int, out_features: Sequence[int] = (256, 256),
                 prenet_type: str = "original", prenet_dropout: bool = True,
                 dropout_at_inference: bool = False, bias: bool = True):
        super().__init__()
        self.num_layers = len(out_features)
        self.use_norm = prenet_type == "bn"
        self.dropout = prenet_dropout and dropout_at_inference
        sizes = (in_features,) + tuple(out_features)
        for i in range(self.num_layers):
            self.add_module(f"linear_{i}", nn.Linear(sizes[i], sizes[i + 1], bias=bias))
            if self.use_norm:
                self.add_module(f"norm_{i}", nn.LayerNorm(sizes[i + 1], eps=1e-6))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"linear_{i}")(x)
            if self.use_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = F.relu(x)
            if self.dropout:
                keep = torch.rand(x.shape, generator=generator, device=x.device) >= 0.5
                x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return x


class ConvBNBlock(nn.Module):
    """conv → norm → activation (reference ``tacotron2.py:11``), ``[B, T, C]``
    in and out. ``norm_type="layer"``: layer norm (flax's epsilon, 1e-6);
    ``"folded"``: the per-channel scale (``weight``) and shift (``bias``) of
    a converted eval-mode BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: Optional[str] = None, norm_type: str = "layer"):
        super().__init__()
        self.activation = activation
        self.conv = Conv1d(in_channels, out_channels, kernel_size)
        if norm_type == "layer":
            self.norm = nn.LayerNorm(out_channels, eps=1e-6)
        elif norm_type == "folded":
            self.weight = nn.Parameter(torch.ones(out_channels))
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            raise ValueError(f"norm_type {norm_type!r}: 'layer' or 'folded'")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.norm(x) if hasattr(self, "norm") else x * self.weight + self.bias
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return x


class Tacotron2Encoder(nn.Module):
    """3 × ConvBN + biLSTM (reference ``tacotron2.py:73``). Outputs at
    padded positions are zero, and the outputs at valid ones do not depend
    on the padding."""

    def __init__(self, in_channels: int, in_out_channels: int = 512, norm_type: str = "layer"):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv_{i}", ConvBNBlock(in_channels if i == 0 else in_out_channels,
                                                     in_out_channels, 5, "relu", norm_type))
        self.lstm = nn.LSTM(in_out_channels, in_out_channels // 2, batch_first=True,
                            bidirectional=True)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"conv_{i}")(x * x_mask)
        lengths = x_mask[:, :, 0].sum(1).long().cpu()
        packed = pack_padded_sequence(x * x_mask, lengths, batch_first=True, enforce_sorted=False)
        out, _ = pad_packed_sequence(self.lstm(packed)[0], batch_first=True,
                                     total_length=x.shape[1])
        return out * x_mask


class Postnet(nn.Module):
    """5 × ConvBN refiner (reference ``tacotron2.py:47``): 512 channels
    inside, tanh on all but the last."""

    def __init__(self, in_out_channels: int, num_convs: int = 5, norm_type: str = "layer"):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            last = i == num_convs - 1
            self.add_module(f"conv_{i}", ConvBNBlock(
                in_out_channels if i == 0 else 512, in_out_channels if last else 512, 5,
                None if last else "tanh", norm_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv_{i}")(x)
        return x


Carry = Tuple[torch.Tensor, ...]


class Tacotron2DecoderCell(nn.Module):
    """One decoder step (reference ``Decoder.decode``, ``tacotron2.py:238``):
    prenet → attention LSTM → attention → decoder LSTM → projection and
    stop token.

    Carry: ``(attn_h, attn_c, dec_h, dec_c, context, attn_w, attn_w_cum,
    alpha, u, mu_prev)``, as in the JAX cell. The attention is
    location-sensitive (``attn_type="original"``; softmax or sigmoid
    normalisation, windowing around the last peak, forward attention with
    an optional transition agent), Graves' GMM (``"graves"``) or dynamic
    convolution (``"dynamic_convolution"``, DCA). The projection is sized
    ``frame_channels × (r_init or r)`` so that ``r`` can shrink without
    changing its shape; the stopnet reads the whole projection and the step
    emits its first ``frame_channels × r`` values."""

    def __init__(self, in_channels: int = 512, frame_channels: int = 80, r: int = 1,
                 r_init: int = 0, query_dim: int = 1024, decoder_rnn_dim: int = 1024,
                 prenet_dim: int = 256, attn_dim: int = 128, prenet_type: str = "original",
                 prenet_dropout: bool = True, prenet_dropout_at_inference: bool = False,
                 location_attn: bool = True, attn_norm: str = "softmax",
                 attn_type: str = "original", attn_K: int = 5, use_forward_attn: bool = False,
                 trans_agent: bool = False, attn_win: bool = False):
        super().__init__()
        self.frame_channels = frame_channels
        self.r = r
        self.query_dim, self.decoder_rnn_dim, self.attn_K = query_dim, decoder_rnn_dim, attn_K
        self.location_attn, self.attn_norm, self.attn_type = location_attn, attn_norm, attn_type
        self.use_forward_attn, self.attn_win = use_forward_attn, attn_win
        self.prenet = Prenet(frame_channels, (prenet_dim, prenet_dim), prenet_type,
                             prenet_dropout, prenet_dropout_at_inference, bias=False)
        self.attention_rnn = nn.LSTMCell(prenet_dim + in_channels, query_dim)
        if attn_type == "dynamic_convolution":
            self.query_layer = nn.Linear(query_dim, attn_dim)
            self.key_layer = nn.Linear(attn_dim, DCA_FILTERS * DCA_KERNEL, bias=False)
            self.static_filter_conv = nn.Conv1d(1, DCA_FILTERS, DCA_KERNEL,
                                                padding=DCA_KERNEL // 2, bias=False)
            self.static_filter_layer = nn.Linear(DCA_FILTERS, attn_dim, bias=False)
            self.dynamic_filter_layer = nn.Linear(DCA_FILTERS, attn_dim)
            self.v = nn.Linear(attn_dim, 1, bias=False)
            # the causal prior filter, flipped: conv1d correlates, jnp.convolve convolves
            self._prior = torch.from_numpy(_betabinom_pmf(10, 0.1, 0.9)[::-1].copy())
        elif attn_type == "graves":
            self.graves_l1 = nn.Linear(query_dim, query_dim)
            self.graves_l2 = nn.Linear(query_dim, 3 * attn_K)
        else:
            self.query_layer = nn.Linear(query_dim, attn_dim, bias=False)
            if location_attn:
                self.location_conv = nn.Conv1d(2, 32, 31, padding=15, bias=False)
                self.location_dense = nn.Linear(32, attn_dim, bias=False)
            self.v = nn.Linear(attn_dim, 1)
        if use_forward_attn and trans_agent:
            self.trans_agent = nn.Linear(in_channels + query_dim, 1)
        self.decoder_rnn = nn.LSTMCell(query_dim + in_channels, decoder_rnn_dim)
        width = frame_channels * (r_init or r)
        self.linear_projection = nn.Linear(decoder_rnn_dim + in_channels, width)
        self.stopnet = nn.Linear(decoder_rnn_dim + width, 1)

    # ------------------------------------------------------------------
    def _dynamic_convolution(self, query, attn_w, input_mask):
        """Monotonic dynamic convolution attention (reference
        ``attentions.py:323``, arXiv:1910.10288). The energies never read
        the encoder, and the mask applies after the softmax with 1e-8 and no
        renormalisation (reference ``:425``), so padded positions take part
        in the softmax."""
        if self._prior.device != attn_w.device:
            self._prior = self._prior.to(attn_w.device)
        prior_f = F.conv1d(F.pad(attn_w[:, None], (len(self._prior) - 1, 0)),
                           self._prior[None, None])[:, 0]
        prior_log = torch.log(torch.clamp(prior_f, min=1e-6))
        G = self.key_layer(torch.tanh(self.query_layer(query)))
        G = G.view(-1, DCA_FILTERS, DCA_KERNEL)
        win = F.pad(attn_w, (DCA_KERNEL // 2, DCA_KERNEL // 2)).unfold(1, DCA_KERNEL, 1)
        dynamic = torch.einsum("btk,bfk->btf", win, G)
        static = self.static_filter_conv(attn_w[:, None]).transpose(1, 2)
        energies = self.v(torch.tanh(self.static_filter_layer(static)
                                     + self.dynamic_filter_layer(dynamic)))[..., 0] + prior_log
        alignment = torch.softmax(energies, dim=-1)
        return torch.where(input_mask, alignment, torch.full_like(alignment, 1e-8))

    def _graves(self, query, mu_prev, input_mask):
        """Graves GMM attention (reference ``attentions.py:40``)."""
        T = input_mask.shape[1]
        gbk = self.graves_l2(F.relu(self.graves_l1(query)))
        g_t, b_t, k_t = torch.split(gbk, self.attn_K, dim=-1)
        sig_t = F.softplus(b_t) + 1e-5
        mu_t = mu_prev + F.softplus(k_t)
        g_t = torch.softmax(g_t, dim=-1) + 1e-5
        j = torch.arange(T, dtype=query.dtype, device=query.device)[None, None, :] + 0.5
        phi = g_t[..., None] * torch.exp(-0.5 * ((mu_t[..., None] - j) / sig_t[..., None]) ** 2)
        alignment = 0.3989422917366028 * phi.sum(dim=1)
        alignment = torch.where(input_mask, alignment, torch.full_like(alignment, 1e-8))
        return alignment / alignment.sum(-1, keepdim=True), mu_t

    def _location(self, query, attn_w, attn_w_cum, alpha, u, processed_inputs, input_mask):
        """Location-sensitive additive attention (reference
        ``attentions.py:127``) with its normalisation, windowing and forward
        attention options."""
        energies = processed_inputs + self.query_layer(query)[:, None, :]
        if self.location_attn:
            loc = self.location_conv(torch.stack([attn_w, attn_w_cum], dim=1))
            energies = energies + self.location_dense(loc.transpose(1, 2))
        scores = self.v(torch.tanh(energies))[..., 0]
        scores = scores.masked_fill(~input_mask, -math.inf)
        if self.attn_win:  # around the previous peak (reference init_win_idx: back 2, front 6)
            peak = torch.argmax(attn_w, dim=-1)[:, None]
            pos = torch.arange(attn_w.shape[1], device=attn_w.device)[None, :]
            scores = scores.masked_fill((pos < peak - 2) | (pos > peak + 6), -math.inf)
        if self.attn_norm == "sigmoid":
            s = torch.sigmoid(scores)
            alignment = s / s.sum(-1, keepdim=True)
        else:
            alignment = torch.softmax(scores, dim=-1)
        if self.use_forward_attn:  # forward attention recursion (reference attentions.py:260)
            fwd_shifted = F.pad(alpha[:, :-1], (1, 0))
            alpha = ((1 - u) * alpha + u * fwd_shifted + 1e-8) * alignment
            alpha = alpha / alpha.sum(-1, keepdim=True)
            alignment = alpha
        return alignment, alpha

    # ------------------------------------------------------------------
    def forward(self, carry: Carry, memory: torch.Tensor, inputs: torch.Tensor,
                processed_inputs: Optional[torch.Tensor], input_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``memory`` ``[B, frame_channels]`` is the previous step's last
        frame (zeros at the first); ``inputs`` the encoder outputs ``[B,
        T_in, C]``, ``processed_inputs`` their ``inputs_layer`` projection
        (location attention only), ``input_mask`` ``[B, T_in]`` boolean.
        Returns ``(carry, (frames [B, frame_channels × r], stop logit [B],
        alignment [B, T_in]))``."""
        attn_h, attn_c, dec_h, dec_c, context, attn_w, attn_w_cum, alpha, u, mu_prev = carry
        processed = self.prenet(memory, generator)
        attn_h, attn_c = self.attention_rnn(torch.cat([processed, context], -1), (attn_h, attn_c))
        query = attn_h
        if self.attn_type == "dynamic_convolution":
            alignment = self._dynamic_convolution(query, attn_w, input_mask)
        elif self.attn_type == "graves":
            alignment, mu_prev = self._graves(query, mu_prev, input_mask)
        else:
            alignment, alpha = self._location(query, attn_w, attn_w_cum, alpha, u,
                                              processed_inputs, input_mask)
        context = torch.bmm(alignment[:, None, :], inputs)[:, 0]
        if hasattr(self, "trans_agent"):  # transition agent gates move/stay (reference :312)
            u = torch.sigmoid(self.trans_agent(torch.cat([context, query], -1)))
        attn_w_cum = attn_w_cum + alignment
        dec_h, dec_c = self.decoder_rnn(torch.cat([query, context], -1), (dec_h, dec_c))
        decoder_output = self.linear_projection(torch.cat([dec_h, context], -1))
        stop_token = self.stopnet(torch.cat([dec_h, decoder_output], -1))[:, 0]
        new_carry = (attn_h, attn_c, dec_h, dec_c, context, alignment, attn_w_cum, alpha, u,
                     mu_prev)
        return new_carry, (decoder_output[:, : self.frame_channels * self.r], stop_token,
                           alignment)

    def init_carry(self, B: int, T_in: int, in_channels: int, device=None,
                   dtype=torch.float32) -> Carry:
        """Zeros, but forward attention's ``alpha`` starts on the first
        token (1, then 1e-7), DCA's attention weights start all on token 0
        (reference ``attentions.py:438``) and ``u`` at 0.5."""
        def z(*shape):
            return torch.zeros(shape, device=device, dtype=dtype)

        alpha0 = torch.full((B, T_in), 1e-7, device=device, dtype=dtype)
        alpha0[:, 0] = 1.0
        w0 = z(B, T_in)
        if self.attn_type == "dynamic_convolution":
            w0[:, 0] = 1.0
        return (z(B, self.query_dim), z(B, self.query_dim), z(B, self.decoder_rnn_dim),
                z(B, self.decoder_rnn_dim), z(B, in_channels), w0, z(B, T_in), alpha0,
                torch.full((B, 1), 0.5, device=device, dtype=dtype), z(B, self.attn_K))
