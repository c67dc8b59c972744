"""Tortoise's neural blocks (port of ``tts_tpu/models/tortoise/layers.py``,
weight-compatible with the reference checkpoints
``TTS/tts/layers/tortoise/{diffusion_decoder,clvp,arch_utils,xtransformers}.py``):
the diffusion mel decoder (``DiffusionTts``), the CLVP reranker and their
shared attention block.

Public layouts are the JAX package's, time-major ``[B, T, C]``; the
convolutions run channel-major ``[B, C, T]`` inside. Module and parameter
names follow the flax modules', so ``utils.convert.flax_to_state_dict`` maps
the JAX parameters by its rules. The T5 relative-position bucket ids are the
port's WavLM ones (``vc.modules.wavlm.bucket_ids``: float64 on the host, as
the JAX package computes them, once per length); CLVP's rotary table is
float64 on the host too, cast to float32, as there. The reference's
layer-drop and classifier-free-training branches are training-only and are
not ported, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vc.modules.wavlm import bucket_ids

__all__ = ["AttentionBlock", "ResBlock", "DiffusionLayer", "DiffusionTts", "CLVP",
           "timestep_embedding"]


def _norm_groups(channels: int) -> int:
    """Reference ``arch_utils.normalization`` group count."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups //= 2
    assert groups > 2
    return groups


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_norm_groups(channels), channels, eps=1e-5)


def _register(module: nn.Module, prefix: str, items) -> list:
    """``items`` registered as ``<prefix>_<i>`` (the flax names), returned
    as a list."""
    items = list(items)
    for i, item in enumerate(items):
        module.add_module(f"{prefix}_{i}", item)
    return items


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B, dim]``, cosines first, like the
    reference (``diffusion_decoder.py:21``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class AttentionBlock(nn.Module):
    """Residual self-attention over ``[B, C, T]`` (reference
    ``arch_utils.AttentionBlock``): GroupNorm, a 1x1 qkv conv (channels laid
    out ``[H][q|k|v][ch]``), attention scaled by ``ch**-1/4`` on each side
    (with the T5 relative position bias where enabled), a 1x1 projection,
    the residual on the block's input."""

    def __init__(self, channels: int, num_heads: int = 1, relative_pos_embeddings: bool = False,
                 rel_num_buckets: int = 32, rel_max_distance: int = 64):
        super().__init__()
        self.heads = num_heads
        self.rel = (rel_num_buckets, rel_max_distance) if relative_pos_embeddings else None
        self.norm = _gn(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        if relative_pos_embeddings:
            self.relative_attention_bias = nn.Parameter(torch.empty(rel_num_buckets, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        B, C, T = x.shape
        H, ch = self.heads, C // self.heads
        qkv = self.qkv(self.norm(x)).reshape(B, H, 3, ch, T)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        dots = torch.einsum("bhct,bhcs->bhts", qkv[:, :, 0] * scale, qkv[:, :, 1] * scale)
        if self.rel is not None:
            ids = bucket_ids(T, self.rel[0], self.rel[1], x.device)
            bias = self.relative_attention_bias[ids]  # [T, T, H]
            dots = dots + bias.permute(2, 0, 1)[None] * math.sqrt(ch)
        probs = torch.softmax(dots, dim=-1)
        out = torch.einsum("bhts,bhcs->bhct", probs, qkv[:, :, 2]).reshape(B, C, T)
        return x + self.proj_out(out)


class ResBlock(nn.Module):
    """Timestep-conditioned residual conv block (reference
    ``diffusion_decoder.ResBlock``, the efficient 1x1 input conv and the
    scale-shift norm) over ``[B, C, T]`` with the timestep embedding
    ``[B, channels]``."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_scale_shift_norm: bool = True, kernel_size: int = 3):
        super().__init__()
        c_out = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = _gn(channels)
        self.in_conv = nn.Conv1d(channels, c_out, 1)
        self.emb = nn.Linear(channels, 2 * c_out if use_scale_shift_norm else c_out)
        self.out_norm = _gn(c_out)
        self.out_conv = nn.Conv1d(c_out, c_out, kernel_size, padding=(kernel_size - 1) // 2)
        self.skip = nn.Conv1d(channels, c_out, 1) if c_out != channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        e = self.emb(F.silu(emb))[:, :, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e)
        h = self.out_conv(F.silu(h))
        return (x if self.skip is None else self.skip(x)) + h


class DiffusionLayer(nn.Module):
    """ResBlock, then an attention block with relative positions (reference
    ``DiffusionLayer``)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.resblk = ResBlock(channels)
        self.attn = AttentionBlock(channels, num_heads, relative_pos_embeddings=True)

    def forward(self, x, emb):
        return self.attn(self.resblk(x, emb))


class DiffusionTts(nn.Module):
    """The Tortoise diffusion mel decoder (reference
    ``diffusion_decoder.DiffusionTts:140``), its latent-conditioned path:
    :meth:`get_conditioning` (the contextual embedder over a univnet-domain
    mel), :meth:`timestep_independent` (the AR latents, conditioned and
    stretched to the output length once per utterance) and the denoiser
    ``forward`` of each diffusion step."""

    def __init__(self, model_channels: int = 1024, num_layers: int = 10, in_channels: int = 100,
                 in_latent_channels: int = 1024, in_tokens: int = 8193, out_channels: int = 200,
                 num_heads: int = 16):
        super().__init__()
        MC, H = model_channels, num_heads
        self.model_channels = MC
        self.inp_block = nn.Conv1d(in_channels, MC, 3, padding=1)
        self.time_embed_0 = nn.Linear(MC, MC)
        self.time_embed_2 = nn.Linear(MC, MC)
        self.cti = _register(self, "cti", (DiffusionLayer(MC, H) for _ in range(3)))
        self.integrating_conv = nn.Conv1d(2 * MC, MC, 1)
        self.layers = _register(self, "layer", (DiffusionLayer(MC, H) for _ in range(num_layers)))
        self.posts = _register(self, "post", (ResBlock(MC) for _ in range(3)))
        self.out_norm = _gn(MC)
        self.out_conv = nn.Conv1d(MC, out_channels, 3, padding=1)
        self.unconditioned_embedding = nn.Parameter(torch.empty(1, 1, MC))
        self.ctx_conv_0 = nn.Conv1d(in_channels, MC, 3, stride=2, padding=1)
        self.ctx_conv_1 = nn.Conv1d(MC, 2 * MC, 3, stride=2, padding=1)
        self.ctx_attn = _register(self, "ctx_attn", (
            AttentionBlock(2 * MC, H, relative_pos_embeddings=True) for _ in range(5)))
        self.lat_conv = nn.Conv1d(in_latent_channels, MC, 3, padding=1)
        self.lat_attn = _register(self, "lat_attn", (
            AttentionBlock(MC, H, relative_pos_embeddings=True) for _ in range(4)))
        self.code_norm = _gn(MC)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                precomputed_embeddings: Optional[torch.Tensor] = None,
                conditioning_free: bool = False) -> torch.Tensor:
        """Noisy mel ``[B, T, in_channels]`` at ``timesteps [B]`` →
        ``[B, T, out_channels]`` (the noise prediction, then the learned
        variance); conditioned on ``precomputed_embeddings [B, T, MC]`` or,
        ``conditioning_free``, on the unconditioned embedding."""
        B, T, _ = x.shape
        if conditioning_free:
            code = self.unconditioned_embedding.expand(B, T, -1)
        else:
            code = precomputed_embeddings
        t_emb = self.time_embed_2(F.silu(self.time_embed_0(
            timestep_embedding(timesteps, self.model_channels))))
        code = code.transpose(1, 2)
        for layer in self.cti:
            code = layer(code, t_emb)
        h = self.integrating_conv(torch.cat([self.inp_block(x.transpose(1, 2)), code], dim=1))
        for layer in self.layers:
            h = layer(h, t_emb)
        for layer in self.posts:
            h = layer(h, t_emb)
        return self.out_conv(F.silu(self.out_norm(h))).transpose(1, 2)

    def get_conditioning(self, conditioning_input: torch.Tensor) -> torch.Tensor:
        """Mel clip ``[B, T, in_channels]`` → latent ``[B, 2*MC]``: the mean
        over time of the contextual embedder."""
        h = self.ctx_conv_1(self.ctx_conv_0(conditioning_input.transpose(1, 2)))
        for block in self.ctx_attn:
            h = block(h)
        return h.mean(dim=2)

    def timestep_independent(self, latents: torch.Tensor, conditioning_latent: torch.Tensor,
                             expected_seq_len: int) -> torch.Tensor:
        """AR latents ``[B, S, in_latent_channels]`` and the conditioning
        latent ``[B, 2*MC]`` → embeddings ``[B, expected_seq_len, MC]``,
        stretched by nearest neighbours (the reference's inference always
        feeds latents, never codes)."""
        h = self.lat_conv(latents.transpose(1, 2))
        for block in self.lat_attn:
            h = block(h)
        scale, shift = conditioning_latent.chunk(2, dim=-1)
        h = self.code_norm(h) * (1 + scale[:, :, None]) + shift[:, :, None]
        S = h.shape[2]
        idx = torch.clamp(torch.arange(expected_seq_len, device=h.device) * S // expected_seq_len,
                          0, S - 1)
        return h[:, :, idx].transpose(1, 2)


# ----------------------------------------------------------------------
# CLVP: the contrastive text/speech reranker (reference clvp.py:20 with
# use_xformers=True: rotary positions, RMSNorm pre-norms, GLU feed-forward)
# ----------------------------------------------------------------------


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.dim**-0.5
        return x / torch.clamp(norm, min=self.eps) * self.g


@functools.lru_cache(maxsize=32)
def _rotary_table(T: int, rot_dim: int) -> np.ndarray:
    """``[T, rot_dim]`` rotary angles in float64 on the host."""
    inv = 1.0 / (10000 ** (np.arange(0, rot_dim, 2) / rot_dim))
    freqs = np.outer(np.arange(T), inv)
    return np.concatenate([freqs, freqs], axis=-1)


def _apply_rotary(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """xtransformers' rotary: the first ``rot_dim`` features of q, k and v
    rotated."""
    rot = freqs.shape[-1]
    tl, tr = t[..., :rot], t[..., rot:]
    x1, x2 = tl[..., : rot // 2], tl[..., rot // 2:]
    tl = tl * torch.cos(freqs) + torch.cat([-x2, x1], dim=-1) * torch.sin(freqs)
    return torch.cat([tl, tr], dim=-1)


class _XAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_k = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_v = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim)

    def forward(self, x, rot):
        B, T, _ = x.shape
        H, dh = self.heads, self.dim_head
        q, k, v = (_apply_rotary(lin(x).reshape(B, T, H, dh).transpose(1, 2), rot)
                   for lin in (self.to_q, self.to_k, self.to_v))
        probs = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * dh**-0.5, dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", probs, v)
        return self.to_out(out.transpose(1, 2).reshape(B, T, H * dh))


class _XFeedForwardGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 2):
        super().__init__()
        inner = int(dim * mult)
        self.proj = nn.Linear(dim, 2 * inner)
        self.out = nn.Linear(inner, dim)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.gelu(gate))


class _XEncoder(nn.Module):
    """xtransformers ``Encoder(use_rmsnorm, ff_glu, rotary_pos_emb)`` and the
    ``ContinuousTransformerWrapper``'s final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, ff_mult: int = 2, rotary_dim: int = 32):
        super().__init__()
        self.rotary_dim = rotary_dim
        self.attn_norm = _register(self, "attn_norm", (_RMSNorm(dim) for _ in range(depth)))
        self.attn = nn.ModuleList([_XAttention(dim, heads) for _ in range(depth)])
        self.ff_norm = _register(self, "ff_norm", (_RMSNorm(dim) for _ in range(depth)))
        self.ff = _register(self, "ff", (_XFeedForwardGLU(dim, ff_mult) for _ in range(depth)))
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        rot = torch.from_numpy(_rotary_table(x.shape[1], self.rotary_dim)).to(x)
        for attn_norm, attn, ff_norm, ff in zip(self.attn_norm, self.attn, self.ff_norm, self.ff):
            x = x + attn(attn_norm(x), rot)
            x = x + ff(ff_norm(x))
        return self.final_norm(x)


class CLVP(nn.Module):
    """Contrastive text and speech scorer that reranks the AR candidates
    (reference ``clvp.py:20``; Tortoise's: 768 wide, 20 layers a side)."""

    def __init__(self, dim_text: int = 768, dim_speech: int = 768, dim_latent: int = 768,
                 num_text_tokens: int = 256, text_enc_depth: int = 20, text_heads: int = 12,
                 num_speech_tokens: int = 8192, speech_enc_depth: int = 20,
                 speech_heads: int = 12):
        super().__init__()
        self.text_emb = nn.Embedding(num_text_tokens, dim_text)
        self.speech_emb = nn.Embedding(num_speech_tokens, dim_speech)
        self.to_text_latent = nn.Linear(dim_text, dim_latent, bias=False)
        self.to_speech_latent = nn.Linear(dim_speech, dim_latent, bias=False)
        self.text_transformer = _XEncoder(dim_text, text_enc_depth, text_heads)
        self.speech_transformer = _XEncoder(dim_speech, speech_enc_depth, speech_heads)
        self.temperature = nn.Parameter(torch.ones(()))

    def forward(self, text: torch.Tensor, speech_tokens: torch.Tensor) -> torch.Tensor:
        """Similarity score per row (reference ``forward(return_loss=False)``
        with full masks, the inference path)."""
        t = self.to_text_latent(self.text_transformer(self.text_emb(text)).mean(dim=1))
        s = self.speech_transformer(self.speech_emb(speech_tokens))
        s = self.to_speech_latent(s.mean(dim=1))
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
        return (t * s).sum(dim=-1) * torch.exp(self.temperature)
