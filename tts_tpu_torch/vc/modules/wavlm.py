"""WavLM content encoder in PyTorch, the FreeVC SSL front end (port of
``tts_tpu/vc/modules/wavlm.py``; reference vendored torch code
``TTS/vc/modules/freevc/wavlm/{wavlm,modules}.py``, itself from
microsoft/unilm).

Inference only, as in the JAX package (FreeVC never trains or masks
WavLM): strided conv feature extractor → ``layer_norm`` → post-projection
when the widths differ → grouped positional convolution → transformer
encoder, pre-LN or post-LN, with WavLM's gated relative position bias (a
T5-style bucketed table owned by layer 0, passed down the stack ungated,
gated per layer by a sigmoid read-out of that layer's unscaled queries).
Time-major ``[B, T, C]`` like the JAX package; GELUs are exact.

The bucket ids are computed as the JAX package computes them, in float64
numpy on the host (a float32 ``log`` moves ids at bucket boundaries), once
per length and device. ``normalize`` is read from a checkpoint but never
applied: the JAX package's ``WavLM.__call__`` does not layer-normalise the
input wave (ROADMAP.md F43), and the port keeps that.

Parameter names follow the JAX module's flax tree (``conv_<i>``,
``ln_<i>``, ``gn_0``, ``pos_conv``, ``layer_<i>``, ``encoder_layer_norm``),
so :func:`tts_tpu_torch.utils.convert.wavlm_from_jax_params` carries flax
params by the generic rules; :func:`load_wavlm` reads the reference
checkpoint (``{"cfg": ..., "model": state_dict}``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device

__all__ = ["WavLMConfig", "WavLM", "load_wavlm", "wavlm_large_config"]

# (dim, kernel, stride) conv stack shared by all WavLM sizes: 5 * 2**6 = 320x
_CONV_LAYERS = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2


@dataclass
class WavLMConfig:
    """Subset of the reference ``WavLMConfig`` that matters at inference
    (copied from ``tts_tpu/vc/modules/wavlm.py:35-65``)."""

    extractor_mode: str = "default"  # "default" (group-norm 1st) | "layer_norm"
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = _CONV_LAYERS
    conv_bias: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = False
    num_buckets: int = 320
    max_distance: int = 1280
    gru_rel_pos: bool = False
    normalize: bool = False

    @classmethod
    def from_checkpoint_cfg(cls, cfg: dict) -> "WavLMConfig":
        """The reference checkpoint's ``cfg`` dict; its ``conv_feature_layers``
        is a Python expression string such as ``"[(512,10,5)] + [(512,3,2)] * 4"``,
        evaluated without builtins."""
        layers = cfg.get("conv_feature_layers", None)
        if isinstance(layers, str):
            layers = eval(layers, {"__builtins__": {}}, {})  # noqa: S307 - reference format
        keep = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in keep}
        if layers is not None:
            kwargs["conv_feature_layers"] = tuple(tuple(t) for t in layers)
        return cls(**kwargs)

    def to_checkpoint_cfg(self) -> dict:
        """The reference checkpoint's ``cfg`` dict for this config, its conv
        stack written as the reference writes it, a string."""
        cfg = dataclasses.asdict(self)
        cfg["conv_feature_layers"] = repr([tuple(t) for t in self.conv_feature_layers])
        return cfg


def wavlm_large_config() -> WavLMConfig:
    """WavLM-Large (the checkpoint FreeVC ships with)."""
    return WavLMConfig(
        extractor_mode="layer_norm",
        encoder_layers=24,
        encoder_embed_dim=1024,
        encoder_ffn_embed_dim=4096,
        encoder_attention_heads=16,
        layer_norm_first=True,
        conv_bias=False,
        relative_position_embedding=True,
        num_buckets=320,
        max_distance=800,
        gru_rel_pos=True,
        normalize=True,
    )


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact, as flax's nn.gelu(approximate=False)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack: wav ``[B, T]`` → frames ``[B, T', 512]``
    (reference ``ConvFeatureExtractionModel``, 320x downsampling), a layer
    norm after every conv (``"layer_norm"``) or a per-channel group norm
    after the first (``"default"``), each followed by GELU."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm_mode = cfg.extractor_mode == "layer_norm"
        in_dim = 1
        for i, (dim, k, stride) in enumerate(cfg.conv_feature_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(in_dim, dim, k, stride=stride,
                                                   bias=cfg.conv_bias))
            if self.layer_norm_mode:
                self.add_module(f"ln_{i}", _layer_norm(dim))
            elif i == 0:
                self.add_module("gn_0", nn.GroupNorm(dim, dim, eps=1e-5))
            in_dim = dim
        self.num_layers = len(cfg.conv_feature_layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = wav[:, None, :]  # [B, 1, T]
        for i in range(self.num_layers):
            h = getattr(self, f"conv_{i}")(h)
            if self.layer_norm_mode:
                h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                h = self.gn_0(h)
            h = _gelu(h)
        return h.transpose(1, 2)  # [B, T', C]


def _relative_position_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket ids ``[T, T]`` (copied from
    ``tts_tpu/vc/modules/wavlm.py:116-132``; reference
    ``_relative_positions_bucket``, ``modules.py:387``), in float64 numpy."""
    ctx = np.arange(T)[:, None]
    mem = np.arange(T)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


@functools.lru_cache(maxsize=32)
def bucket_ids(T: int, num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """:func:`_relative_position_buckets` as an int64 tensor on ``device``,
    computed on the host once per length and moved once."""
    ids = _relative_position_buckets(T, num_buckets, max_distance)
    return torch.from_numpy(ids).to(device)


class SelfAttention(nn.Module):
    """WavLM multi-head self-attention with the gated relative position
    bias (``modules.py:490-500``). With ``has_relative_attention_bias`` and
    no ``pos_bias`` given, the bias table ``[H, T, T]`` is built from this
    layer's ``relative_attention_bias`` and returned ungated, for the layers
    below; each layer gates its own copy with ``grep_linear`` of its
    queries (``q_proj``'s output, unscaled) and ``grep_a``."""

    def __init__(self, dim: int, heads: int, has_relative_attention_bias: bool = False,
                 num_buckets: int = 320, max_distance: int = 1280, gru_rel_pos: bool = False):
        super().__init__()
        self.heads = heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.gru_rel_pos = gru_rel_pos
        self.has_relative_attention_bias = has_relative_attention_bias
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Parameter(torch.empty(num_buckets, heads))
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        if gru_rel_pos:
            self.grep_linear = nn.Linear(dim // heads, 8)
            self.grep_a = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None):
        B, T, D = x.shape
        H = self.heads
        dh = D // H
        if self.has_relative_attention_bias and pos_bias is None:
            ids = bucket_ids(T, self.num_buckets, self.max_distance, x.device)
            pos_bias = self.relative_attention_bias[ids].permute(2, 0, 1)  # [H, T, T]
        q = self.q_proj(x).view(B, T, H, dh).transpose(1, 2)  # [B, H, T, dh]
        k = self.k_proj(x).view(B, T, H, dh).transpose(1, 2)
        v = self.v_proj(x).view(B, T, H, dh).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)  # [B, H, T, T]
        if pos_bias is not None:
            bias = pos_bias[None]
            if self.gru_rel_pos:
                gates = self.grep_linear(q).view(B, H, T, 2, 4).sum(-1)
                gate_a, gate_b = torch.sigmoid(gates).chunk(2, dim=-1)
                gate = gate_a * (gate_b * self.grep_a - 1.0) + 2.0  # [B, H, T, 1]
                bias = gate * bias
            scores = scores + bias
        out = torch.matmul(torch.softmax(scores, dim=-1), v)  # [B, H, T, dh]
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D)), pos_bias


class EncoderLayer(nn.Module):
    """Transformer layer, pre-LN (``layer_norm_first``) or post-LN."""

    def __init__(self, cfg: WavLMConfig, has_relative_attention_bias: bool = False):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.layer_norm_first = cfg.layer_norm_first
        self.self_attn = SelfAttention(
            D, cfg.encoder_attention_heads, has_relative_attention_bias, cfg.num_buckets,
            cfg.max_distance, cfg.gru_rel_pos)
        self.self_attn_layer_norm = _layer_norm(D)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, D)
        self.final_layer_norm = _layer_norm(D)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor]):
        if self.layer_norm_first:
            h, pos_bias = self.self_attn(self.self_attn_layer_norm(x), pos_bias)
            x = x + h
            x = x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))
        else:
            h, pos_bias = self.self_attn(x, pos_bias)
            x = self.self_attn_layer_norm(x + h)
            x = self.final_layer_norm(x + self.fc2(_gelu(self.fc1(x))))
        return x, pos_bias


class WavLM(nn.Module):
    """wav ``[B, T]`` at 16 kHz → content features ``[B, T', encoder_embed_dim]``;
    ``output_layer`` stops after that many layers (and skips the final
    layer norm of a pre-LN model), as the JAX module does."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        width = cfg.conv_feature_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = _layer_norm(width)
        if width != D:
            self.post_extract_proj = nn.Linear(width, D)
        # weight norm folded by the converter; an even kernel drops the
        # trailing frame (the reference's SamePad)
        self.pos_conv = nn.Conv1d(D, D, cfg.conv_pos, padding=cfg.conv_pos // 2,
                                  groups=cfg.conv_pos_groups)
        self.encoder_layer_norm = _layer_norm(D)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg, has_relative_attention_bias=cfg.relative_position_embedding and i == 0))

    def forward(self, wav: torch.Tensor, output_layer: Optional[int] = None) -> torch.Tensor:
        c = self.cfg
        feats = self.layer_norm(self.feature_extractor(wav))
        if hasattr(self, "post_extract_proj"):
            feats = self.post_extract_proj(feats)
        pos = self.pos_conv(feats.transpose(1, 2))
        if c.conv_pos % 2 == 0:
            pos = pos[:, :, :-1]
        x = feats + _gelu(pos).transpose(1, 2)
        if not c.layer_norm_first:
            x = self.encoder_layer_norm(x)
        pos_bias = None
        n_layers = c.encoder_layers if output_layer is None else output_layer
        for i in range(min(n_layers, c.encoder_layers)):
            x, pos_bias = getattr(self, f"layer_{i}")(x, pos_bias)
        if c.layer_norm_first and output_layer is None:
            x = self.encoder_layer_norm(x)
        return x


def load_wavlm(checkpoint_path: Optional[str] = None, device="cuda") -> WavLM:
    """The WavLM of a reference checkpoint (``{"cfg": ..., "model":
    state_dict}``, read with ``weights_only=True``), in eval mode on
    ``device``: a callable ``wav [B, T] → features [B, T', D]``.
    ``checkpoint_path`` defaults to ``$TTS_HOME/wavlm/WavLM-Large.pt``
    (``~/.local/share/tts`` without ``TTS_HOME``), where the JAX package
    and the reference look (``wavlm/__init__.py:12``). Nothing is
    fetched: a missing file raises ``FileNotFoundError`` naming its path.
    Nothing is written either; the JAX package writes a converted
    ``.msgpack`` beside the ``.pt`` (``tts_tpu/vc/modules/wavlm.py:280-290``)."""
    from tts_tpu_torch.utils.convert import load_reference_wavlm

    device = resolve_device(device)
    home = os.environ.get("TTS_HOME",
                          os.path.join(os.path.expanduser("~"), ".local", "share", "tts"))
    path = checkpoint_path or os.path.join(home, "wavlm", "WavLM-Large.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"WavLM checkpoint not found at {path}: place the reference WavLM-Large.pt there "
            f"(nothing is downloaded)")
    cfg, state = load_reference_wavlm(path)
    with torch.device("meta"):
        model = WavLM(cfg)
    model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
    return model.eval().requires_grad_(False)
