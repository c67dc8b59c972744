"""GPT-2 style decoder core with a KV cache (port of
``tts_tpu/models/xtts/gpt_core.py``).

The cache is preallocated per layer as ``[B, max_len, H, dh]`` tensors and
updated **in place** (the JAX version threads a functional cache through a
``lax.scan``). A decode step (one token with a valid length) goes through
``ops.decode_attention``, which launches the hand-written Hopper kernel on
CUDA tensors. Prefill attends over the chunk it writes: causally by
default, over the whole chunk (``causal=False``: Bark's fine model), or
under an explicit boolean ``attn_mask [T, S]`` over the first ``S`` cache
slots (Bark's coarse windows mask a padded tail). The JAX version attends
over the whole ``max_len`` cache under a mask padded with zeros, so the
slots past the mask never contribute there either.

Bark's variants are constructor flags, as in the JAX core: ``bias=False``
drops the bias of every ``Linear`` and every ``LayerNorm`` (``ln_f``
included), ``gelu_exact=True`` takes the erf gelu. The defaults (biases,
the tanh gelu) are what XTTS and Tortoise's ``UnifiedVoice`` run on. Ring
attention (``seq_axis``) and rematerialization (``remat``) are
training-only in the JAX package and are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.ops.decode_attention import decode_attention


@dataclass
class KVCache:
    """Per-layer ``[B, max_len, H, dh]`` keys and values, written in place."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]


class GPT2Attention(nn.Module):
    def __init__(self, dim: int, heads: int, bias: bool = True):
        super().__init__()
        self.heads = heads
        self.c_attn = nn.Linear(dim, 3 * dim, bias=bias)
        self.c_proj = nn.Linear(dim, dim, bias=bias)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        causal: bool = True,
        k_cache: Optional[torch.Tensor] = None,  # [B, S, H, dh], written in place
        v_cache: Optional[torch.Tensor] = None,
        cache_index: int = 0,
        cache_len=None,  # decode: valid cache length (int or [B] tensor)
        attn_mask: Optional[torch.Tensor] = None,  # prefill: bool [T, S], True = attend
    ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.heads
        dh = D // H
        q, k, v = self.c_attn(x).split(D, dim=-1)
        q = q.reshape(B, T, H, dh)
        k = k.reshape(B, T, H, dh)
        v = v.reshape(B, T, H, dh)
        if k_cache is not None:
            k_cache[:, cache_index : cache_index + T] = k
            v_cache[:, cache_index : cache_index + T] = v

        if k_cache is not None and T == 1 and cache_len is not None:
            # hot decode step: one query against the cache
            out = decode_attention(q[:, 0], k_cache, v_cache, cache_len)  # fp32 [B, H, dh]
            return self.c_proj(out.to(x.dtype).reshape(B, 1, D))

        if attn_mask is not None and k_cache is not None:
            S = attn_mask.shape[-1]  # the first S keys of the cache
            k, v = k_cache[:, :S], v_cache[:, :S]
        elif attn_mask is None and causal:
            attn_mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask, -1e9)
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(v.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)
        return self.c_proj(out)


class GPT2Block(nn.Module):
    def __init__(self, dim: int, heads: int, bias: bool = True, gelu_exact: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5, bias=bias)
        self.attn = GPT2Attention(dim, heads, bias)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5, bias=bias)
        self.mlp_fc = nn.Linear(dim, 4 * dim, bias=bias)
        self.mlp_proj = nn.Linear(4 * dim, dim, bias=bias)
        # HF GPT-2's gelu_new (tanh), or Bark's exact erf gelu
        self.gelu = "none" if gelu_exact else "tanh"

    def forward(self, x, causal=True, k_cache=None, v_cache=None, cache_index=0, cache_len=None,
                attn_mask=None):
        x = x + self.attn(self.ln_1(x), causal, k_cache, v_cache, cache_index, cache_len,
                          attn_mask)
        m = F.gelu(self.mlp_fc(self.ln_2(x)), approximate=self.gelu)
        return x + self.mlp_proj(m)


class GPT2Core(nn.Module):
    """Stack of GPT-2 blocks and the final LayerNorm. Position embeddings
    belong to the caller (XTTS keeps separate text and mel tables)."""

    def __init__(self, layers: int, dim: int, heads: int, bias: bool = True,
                 gelu_exact: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.h = nn.ModuleList([GPT2Block(dim, heads, bias, gelu_exact) for _ in range(layers)])
        self.ln_f = nn.LayerNorm(dim, eps=1e-5, bias=bias)

    def forward(
        self,
        h: torch.Tensor,  # [B, T, D] embedded inputs
        causal: bool = True,
        cache: Optional[KVCache] = None,
        cache_index: int = 0,
        cache_len=None,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        for i, block in enumerate(self.h):
            k_i = cache.k[i] if cache is not None else None
            v_i = cache.v[i] if cache is not None else None
            h = block(h, causal, k_i, v_i, cache_index, cache_len, attn_mask)
        return self.ln_f(h)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None) -> KVCache:
        """Zeroed cache: one ``[L, B, max_len, H, dh]`` buffer each for K and V,
        handed out as per-layer contiguous views."""
        dh = self.dim // self.heads
        shape = (len(self.h), batch, max_len, self.heads, dh)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        return KVCache(k=list(k.unbind(0)), v=list(v.unbind(0)))


def sample_logits(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.75,
    top_k: int = 50,
    top_p: float = 0.85,
    repetition_counts: Optional[torch.Tensor] = None,  # [B, V]
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """Repetition penalty → temperature → top-k → nucleus inside the top-k
    → categorical draw, in the JAX package's order. The draw is Gumbel-max
    with noise from ``generator`` (as ``jax.random.categorical`` draws), so
    it stays on the device with no host sync."""
    if repetition_counts is not None and repetition_penalty != 1.0:
        penal = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
        logits = torch.where(repetition_counts > 0, penal, logits)
    logits = logits / max(temperature, 1e-5)

    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        vals, idx = torch.topk(logits, top_k, dim=-1)  # descending
        if top_p and top_p < 1.0:
            cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
            n_keep = torch.sum(cum < top_p, dim=-1, keepdim=True)  # always keep top-1
            keep = torch.arange(top_k, device=logits.device)[None] <= n_keep
            vals = vals.masked_fill(~keep, -1e9)
        choice = _categorical(vals, generator)
        return torch.gather(idx, 1, choice[:, None])[:, 0]
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff_val = torch.gather(sorted_logits, 1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff_val, -1e9)
    return _categorical(logits, generator)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max draw: ``argmax(logits + Gumbel noise)``."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    e.exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)
