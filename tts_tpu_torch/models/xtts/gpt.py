"""XTTS GPT: conditioned autoregressive decoder over mel codes (port of
``tts_tpu/models/xtts/gpt.py``).

Sequence layout: ``[cond_latents | start_text text… stop_text | start_audio
codes… stop_audio]``, with separate learned position tables for the text and
mel segments. The conditioning latents are the perceiver's 32 (v2), or
without it (the v1 layout) one per conditioning mel frame. Module and parameter names mirror the flax ones, so
``utils.convert.xtts_from_jax_params`` maps a JAX param tree by rule.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .gpt_core import GPT2Core, sample_logits


def _attend(q, k, v, scale):
    """Softmax attention over ``[B, T, H, dh]`` (no mask), fp32 softmax."""
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class AttentionBlock(nn.Module):
    """Self-attention block of the conditioning encoder."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(self.num_groups(dim), dim, eps=1e-6)  # flax's default eps
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj_out = nn.Linear(dim, dim)

    @staticmethod
    def num_groups(channels: int) -> int:
        groups = 32 if channels > 64 else (16 if channels > 16 else 8)
        while channels % groups != 0:
            groups //= 2
        return groups

    def forward(self, x):  # [B, T, D]
        h = self.norm(x.transpose(1, 2)).transpose(1, 2)
        B, T, D = h.shape
        qkv = self.qkv(h).reshape(B, T, 3, self.heads, D // self.heads)
        out = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], 1.0 / math.sqrt(D // self.heads))
        # the skip rides the NORMALIZED input (reference latent_encoder.py:109)
        return h + self.proj_out(out.reshape(B, T, D))


class ConditioningEncoder(nn.Module):
    """mel ``[B, T, 80]`` → conditioning features ``[B, T, D]``."""

    def __init__(self, embedding_dim: int, attn_blocks: int = 6, num_attn_heads: int = 4):
        super().__init__()
        self.init = nn.Linear(80, embedding_dim)
        self.attn = nn.ModuleList(
            [AttentionBlock(embedding_dim, num_attn_heads) for _ in range(attn_blocks)]
        )

    def forward(self, x):
        h = self.init(x)
        for block in self.attn:
            h = block(h)
        return h


class PerceiverResampler(nn.Module):
    """32 learned latents cross-attend to the conditioning features: no
    pre-norms, latents prepended to the context, GEGLU feed-forward
    ``val * gelu(gate)`` (exact gelu) of inner width ``dim*mult*2/3``, and a
    final ``x / ‖x‖ · √dim · γ`` norm."""

    def __init__(self, dim: int, depth: int = 2, num_latents: int = 32, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        inner = dim_head * heads
        ff_inner = int(dim * ff_mult * 2 / 3)
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        self.to_q = nn.ModuleList([nn.Linear(dim, inner, bias=False) for _ in range(depth)])
        self.to_kv = nn.ModuleList([nn.Linear(dim, 2 * inner, bias=False) for _ in range(depth)])
        self.to_out = nn.ModuleList([nn.Linear(inner, dim, bias=False) for _ in range(depth)])
        self.ff1 = nn.ModuleList([nn.Linear(dim, 2 * ff_inner) for _ in range(depth)])
        self.ff2 = nn.ModuleList([nn.Linear(ff_inner, dim) for _ in range(depth)])
        self.norm_gamma = nn.Parameter(torch.ones(dim))
        self.reset_parameters()

    def reset_parameters(self):
        nn.init.normal_(self.latents, std=0.02)
        nn.init.ones_(self.norm_gamma)

    def forward(self, ctx):  # [B, S, D]
        B = ctx.shape[0]
        x = self.latents[None].expand(B, -1, -1)
        for to_q, to_kv, to_out, ff1, ff2 in zip(
            self.to_q, self.to_kv, self.to_out, self.ff1, self.ff2
        ):
            q = to_q(x).reshape(B, -1, self.heads, self.dim_head)
            k, v = to_kv(torch.cat([x, ctx], dim=1)).chunk(2, dim=-1)
            k = k.reshape(B, -1, self.heads, self.dim_head)
            v = v.reshape(B, -1, self.heads, self.dim_head)
            out = _attend(q, k, v, 1.0 / math.sqrt(self.dim_head))
            x = x + to_out(out.reshape(B, -1, self.heads * self.dim_head))
            val, gate = ff1(x).chunk(2, dim=-1)
            x = x + ff2(F.gelu(gate) * val)
        norm = torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return x / norm * math.sqrt(self.dim) * self.norm_gamma


class XttsGPT(nn.Module):
    def __init__(
        self,
        layers: int = 30,
        model_dim: int = 1024,
        heads: int = 16,
        number_text_tokens: int = 6681,
        num_audio_tokens: int = 1026,
        start_audio_token: int = 1024,
        stop_audio_token: int = 1025,
        start_text_token: int = 261,
        stop_text_token: int = 0,
        max_text_tokens: int = 402,
        max_mel_tokens: int = 605,
        use_perceiver_resampler: bool = True,
    ):
        super().__init__()
        D = model_dim
        self.num_audio_tokens = num_audio_tokens
        self.start_audio_token, self.stop_audio_token = start_audio_token, stop_audio_token
        self.start_text_token, self.stop_text_token = start_text_token, stop_text_token
        self.max_mel_tokens = max_mel_tokens
        self.conditioning_encoder = ConditioningEncoder(D, attn_blocks=6, num_attn_heads=heads)
        # the XTTS v1 layout has no perceiver: every conditioning frame is a
        # prompt latent
        self.conditioning_perceiver = PerceiverResampler(
            dim=D, depth=2, num_latents=32, dim_head=64, heads=8
        ) if use_perceiver_resampler else None
        self.text_embedding = nn.Embedding(number_text_tokens, D)
        self.mel_embedding = nn.Embedding(num_audio_tokens, D)
        self.text_pos_embedding = nn.Parameter(torch.empty(max_text_tokens + 2, D))
        self.mel_pos_embedding = nn.Parameter(torch.empty(max_mel_tokens + 3, D))
        self.gpt = GPT2Core(layers=layers, dim=D, heads=heads)
        self.final_norm = nn.LayerNorm(D, eps=1e-5)
        self.text_head = nn.Linear(D, number_text_tokens)
        self.mel_head = nn.Linear(D, num_audio_tokens)
        self.reset_parameters()
        # decode steps run (one per token position, covering all rows) and
        # tokens decoded (rows × steps); serving threads may decode at once,
        # hence the lock
        self.decode_steps = 0
        self.decode_tokens = 0
        self._steps_lock = threading.Lock()

    def reset_parameters(self):
        nn.init.normal_(self.text_pos_embedding, std=0.02)
        nn.init.normal_(self.mel_pos_embedding, std=0.02)

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype, read from a named parameter that int8 serving
        leaves float (not from whichever floating parameter comes first)."""
        return self.mel_pos_embedding.dtype

    # ------------------------------------------------------------------
    def get_style_emb(self, cond_mels: torch.Tensor) -> torch.Tensor:
        """cond mel ``[B, T, 80]`` → conditioning latents: ``[B, 32, D]``
        through the perceiver, ``[B, T, D]`` without it (the v1 layout)."""
        h = self.conditioning_encoder(cond_mels.to(self.dtype))
        return h if self.conditioning_perceiver is None else self.conditioning_perceiver(h)

    def _embed_text(self, text_ids):
        return self.text_embedding(text_ids) + self.text_pos_embedding[None, : text_ids.shape[1]]

    def _mel_pos(self, start: int, length: int) -> torch.Tensor:
        # no decode reaches past the table (streaming stops at
        # max_mel_tokens - 3, as the full decode does); the JAX package's
        # dynamic_slice would clamp instead (ROADMAP.md F5)
        if start + length > self.mel_pos_embedding.shape[0]:
            raise ValueError(f"mel positions {start}..{start + length - 1} pass the "
                             f"{self.mel_pos_embedding.shape[0]}-row position table")
        return self.mel_pos_embedding[start : start + length]

    def _embed_mel(self, mel_ids, offset: int = 0):
        return self.mel_embedding(mel_ids) + self._mel_pos(offset, mel_ids.shape[1])[None]

    def _wrap(self, ids, lengths, start, stop):
        idx = torch.arange(ids.shape[1], device=ids.device)[None]
        ids = torch.where(idx < lengths[:, None], ids, stop)
        B = ids.shape[0]
        return torch.cat(
            [ids.new_full((B, 1), start), ids, ids.new_full((B, 1), stop)], dim=1
        )

    def forward(
        self,
        text_inputs: torch.Tensor,  # [B, T_text] (no special tokens)
        text_lengths: torch.Tensor,
        audio_codes: torch.Tensor,  # [B, T_mel] codes (no special tokens)
        code_lengths: torch.Tensor,
        cond_mels: Optional[torch.Tensor] = None,
        cond_latents: Optional[torch.Tensor] = None,
        return_latent: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward → text/mel logits and mel latents."""
        if cond_latents is None:
            cond_latents = self.get_style_emb(cond_mels)
        L_c = cond_latents.shape[1]
        text_wrapped = self._wrap(text_inputs, text_lengths, self.start_text_token,
                                  self.stop_text_token)
        mel_wrapped = self._wrap(audio_codes, code_lengths, self.start_audio_token,
                                 self.stop_audio_token)
        h = torch.cat(
            [cond_latents.to(self.dtype), self._embed_text(text_wrapped),
             self._embed_mel(mel_wrapped)], dim=1,
        )
        h = self.final_norm(self.gpt(h, causal=True))
        T_text = text_wrapped.shape[1]
        text_latents = h[:, L_c : L_c + T_text]
        mel_latents = h[:, L_c + T_text :]
        if return_latent:
            return {"latents": mel_latents[:, :-1]}
        return {
            "text_logits": self.text_head(text_latents[:, :-1]),
            "mel_logits": self.mel_head(mel_latents[:, :-1]),
            "text_targets": text_wrapped[:, 1:],
            "mel_targets": mel_wrapped[:, 1:],
            "latents": mel_latents[:, :-1],
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(
        self,
        cond_latents: torch.Tensor,  # [B, L_c, D]
        text_inputs: torch.Tensor,  # [B, T_text] token ids (unwrapped)
        text_lengths: torch.Tensor,
        max_new_tokens: int = 600,
    ) -> Dict:
        """Run the conditioning + text prefix once into a fresh KV cache;
        returns the decode state for :meth:`decode_chunk`. Pad positions of
        shorter rows become stop tokens."""
        B = text_inputs.shape[0]
        text_wrapped = self._wrap(text_inputs, text_lengths, self.start_text_token,
                                  self.stop_text_token)
        start = text_inputs.new_full((B, 1), self.start_audio_token)
        prefix = torch.cat(
            [cond_latents.to(self.dtype), self._embed_text(text_wrapped), self._embed_mel(start)],
            dim=1,
        )
        L_pre = prefix.shape[1]
        cache = self.gpt.init_cache(B, L_pre + max_new_tokens, prefix.dtype, prefix.device)
        h = self.final_norm(self.gpt(prefix, causal=True, cache=cache, cache_index=0))
        dev = prefix.device
        return {
            "cache": cache,
            "cur_index": L_pre,  # host ints: the decode loop needs no device reads
            "tok_pos": 1,
            "last_logits": self.mel_head(h[:, -1]),
            "last_h": h[:, -1],
            "rep_counts": torch.zeros((B, self.num_audio_tokens), dtype=torch.int32, device=dev),
            "done": torch.zeros((B,), dtype=torch.bool, device=dev),
            "out_len": torch.zeros((B,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def decode_chunk(
        self,
        state: Dict,
        generator: Optional[torch.Generator] = None,
        chunk_size: int = 20,
        temperature: float = 0.75,
        top_k: int = 50,
        top_p: float = 0.85,
        repetition_penalty: float = 5.0,
    ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
        """Decode ``chunk_size`` tokens. Returns (state, tokens ``[B, chunk]``,
        latents ``[B, chunk, D]``); the KV cache is updated in place. Each
        emitted latent is the hidden state that PREDICTED its token (the
        previous position's), as in the reference."""
        cache = state["cache"]
        cur, pos = state["cur_index"], state["tok_pos"]
        logits, last_h = state["last_logits"], state["last_h"]
        rep, done, out_len = state["rep_counts"], state["done"], state["out_len"]
        toks, lats = [], []
        for _ in range(chunk_size):
            tok = sample_logits(
                logits, generator, temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_counts=rep, repetition_penalty=repetition_penalty,
            )
            tok = torch.where(done, self.stop_audio_token, tok)
            done = done | (tok == self.stop_audio_token)
            out_len = out_len + (~done).to(torch.int32)
            rep = rep.scatter_add(1, tok[:, None], torch.ones_like(rep[:, :1]))
            emb = self.mel_embedding(tok)[:, None] + self._mel_pos(pos, 1)[None]
            # decode validity is exactly "positions <= cur", a scalar length
            h = self.gpt(emb, cache=cache, cache_index=cur, cache_len=cur + 1)
            h = self.final_norm(h)[:, -1]
            toks.append(tok)
            lats.append(last_h)
            logits, last_h = self.mel_head(h), h
            cur, pos = cur + 1, pos + 1
            with self._steps_lock:
                self.decode_steps += 1
                self.decode_tokens += tok.shape[0]
        new_state = {
            "cache": cache, "cur_index": cur, "tok_pos": pos, "last_logits": logits,
            "last_h": last_h, "rep_counts": rep, "done": done, "out_len": out_len,
        }
        return new_state, torch.stack(toks, dim=1), torch.stack(lats, dim=1)

    @torch.no_grad()
    def generate(
        self,
        cond_latents: torch.Tensor,
        text_inputs: torch.Tensor,
        text_lengths: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: int = 600,
        temperature: float = 0.75,
        top_k: int = 50,
        top_p: float = 0.85,
        repetition_penalty: float = 5.0,
    ) -> Dict[str, torch.Tensor]:
        """KV-cached generation → codes ``[B, max_new_tokens]`` (stop-padded),
        their lengths, and the latents."""
        state = self.prefill(cond_latents, text_inputs, text_lengths, max_new_tokens)
        state, tokens, latents = self.decode_chunk(
            state, generator, chunk_size=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
        )
        return {"codes": tokens, "code_lengths": state["out_len"], "latents": latents}
