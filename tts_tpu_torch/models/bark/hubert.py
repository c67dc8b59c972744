"""Bark's voice-prompt front end: HuBERT features → semantic tokens (port of
``tts_tpu/models/bark/hubert.py``; reference
``TTS/tts/layers/bark/hubert/{kmeans_hubert,tokenizer}.py``).

The reference wraps HF ``HubertModel("facebook/hubert-base-ls960")`` and a
small LSTM ``HubertTokenizer`` that maps layer-9 features to Bark semantic
token ids. HuBERT-base runs on the port's WavLM
(``vc/modules/wavlm.py``): the same conv extractor (group norm after the
first conv), feature projection, grouped positional convolution and post-LN
transformer, without the gated relative position bias. The tokenizer is a
2-layer LSTM and a linear head (and an intermediate layer in version 1).

The converters :func:`convert_hf_hubert` and
:func:`convert_hubert_tokenizer` (copied from
``tts_tpu/models/bark/hubert.py:77-170``, with the port's own kernel
helpers) map the reference state dicts to the flax layout, which the port's
generic rules carry (:func:`load_hubert`, :func:`load_hubert_tokenizer`).
Nothing is fetched: the zoo's ``hubert.pt`` and ``tokenizer.pth`` are read
from where they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.vc.modules.wavlm import WavLM, WavLMConfig

__all__ = ["hubert_base_config", "HubertTokenizer", "convert_hf_hubert",
           "convert_hubert_tokenizer", "load_hubert", "load_hubert_tokenizer",
           "semantic_tokens_from_audio"]


def hubert_base_config() -> WavLMConfig:
    """facebook/hubert-base-ls960's dims as a WavLM config (no relative
    positions)."""
    return WavLMConfig(
        extractor_mode="default",
        encoder_layers=12,
        encoder_embed_dim=768,
        encoder_ffn_embed_dim=3072,
        encoder_attention_heads=12,
        layer_norm_first=False,
        conv_bias=False,
        relative_position_embedding=False,
        gru_rel_pos=False,
    )


class HubertTokenizer(nn.Module):
    """HuBERT features ``[B, T, input_size]`` → semantic-token logits
    (reference ``tokenizer.py:16``; version 0: two LSTM layers and a linear
    head, version 1 with a 4096-wide layer between)."""

    def __init__(self, hidden_size: int = 1024, input_size: int = 768,
                 output_size: int = 10000, version: int = 0):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, 2, batch_first=True)
        if version == 1:
            self.intermediate = nn.Linear(hidden_size, 4096)
        self.fc = nn.Linear(4096 if version == 1 else hidden_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.lstm(x)[0]
        if hasattr(self, "intermediate"):
            h = self.intermediate(h)
        return self.fc(h)

    @torch.no_grad()
    def get_token(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self(x), dim=-1)


# ----------------------------------------------------------------------
# converters (HF HubertModel / reference HubertTokenizer state dicts)
# ----------------------------------------------------------------------

def convert_hf_hubert(state: dict) -> dict:
    """HF ``HubertModel`` state dict → flax WavLM params (hubert layout)."""
    from tts_tpu_torch.utils.convert import conv1d_kernel, linear_kernel

    s = {k: np.asarray(v) for k, v in state.items()}
    p: dict = {}

    fe = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in s:
        fe[f"conv_{i}"] = {
            "kernel": conv1d_kernel(s[f"feature_extractor.conv_layers.{i}.conv.weight"])
        }
        if f"feature_extractor.conv_layers.{i}.conv.bias" in s:
            fe[f"conv_{i}"]["bias"] = s[f"feature_extractor.conv_layers.{i}.conv.bias"]
        i += 1
    fe["gn_0"] = {
        "scale": s["feature_extractor.conv_layers.0.layer_norm.weight"],
        "bias": s["feature_extractor.conv_layers.0.layer_norm.bias"],
    }
    p["feature_extractor"] = fe

    p["layer_norm"] = {
        "scale": s["feature_projection.layer_norm.weight"],
        "bias": s["feature_projection.layer_norm.bias"],
    }
    p["post_extract_proj"] = {
        "kernel": linear_kernel(s["feature_projection.projection.weight"]),
        "bias": s["feature_projection.projection.bias"],
    }

    # weight-norm parametrized positional conv: fold g·v/|v|
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in s:
        g, v = s[f"{base}.weight_g"], s[f"{base}.weight_v"]
    else:  # torch >= 2.1 parametrize layout
        g = s[f"{base}.parametrizations.weight.original0"]
        v = s[f"{base}.parametrizations.weight.original1"]
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # torch [O, I/g, K]
    p["pos_conv"] = {"kernel": conv1d_kernel(w), "bias": s[f"{base}.bias"]}

    p["encoder_layer_norm"] = {
        "scale": s["encoder.layer_norm.weight"],
        "bias": s["encoder.layer_norm.bias"],
    }

    n = 0
    while f"encoder.layers.{n}.attention.q_proj.weight" in s:
        b = f"encoder.layers.{n}."
        attn = {}
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            attn[proj] = {
                "kernel": linear_kernel(s[f"{b}attention.{proj}.weight"]),
                "bias": s[f"{b}attention.{proj}.bias"],
            }
        p[f"layer_{n}"] = {
            "self_attn": attn,
            "self_attn_layer_norm": {
                "scale": s[f"{b}layer_norm.weight"], "bias": s[f"{b}layer_norm.bias"]
            },
            "fc1": {
                "kernel": linear_kernel(s[f"{b}feed_forward.intermediate_dense.weight"]),
                "bias": s[f"{b}feed_forward.intermediate_dense.bias"],
            },
            "fc2": {
                "kernel": linear_kernel(s[f"{b}feed_forward.output_dense.weight"]),
                "bias": s[f"{b}feed_forward.output_dense.bias"],
            },
            "final_layer_norm": {
                "scale": s[f"{b}final_layer_norm.weight"],
                "bias": s[f"{b}final_layer_norm.bias"],
            },
        }
        n += 1
    return {"params": p}


def convert_hubert_tokenizer(state: dict) -> dict:
    """Reference ``HubertTokenizer`` state dict → flax params."""
    from tts_tpu_torch.utils.convert import _lstm_cell, linear_kernel

    s = {k: np.asarray(v) for k, v in state.items()}
    p = {
        "lstm0": _lstm_cell(s, "lstm", "_l0"),
        "lstm1": _lstm_cell(s, "lstm", "_l1"),
        "fc": {"kernel": linear_kernel(s["fc.weight"]), "bias": s["fc.bias"]},
    }
    if "intermediate.weight" in s:
        p["intermediate"] = {
            "kernel": linear_kernel(s["intermediate.weight"]),
            "bias": s["intermediate.bias"],
        }
    return {"params": p}


def _load(module: nn.Module, state: Mapping[str, torch.Tensor], device) -> nn.Module:
    module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def load_hubert(state: Mapping, cfg: WavLMConfig = None, device="cuda") -> WavLM:
    """An HF ``HubertModel`` state dict (numpy or tensors) → the port's WavLM
    in HuBERT's layout on ``device`` (``cfg`` defaults to HuBERT-base)."""
    from tts_tpu_torch.utils.convert import _to_numpy, wavlm_from_jax_params

    state = {k: _to_numpy(v) for k, v in state.items()}
    with torch.device("meta"):
        model = WavLM(cfg or hubert_base_config())
    return _load(model, wavlm_from_jax_params(convert_hf_hubert(state)), resolve_device(device))


def load_hubert_tokenizer(state: Mapping, device="cuda") -> HubertTokenizer:
    """A reference ``HubertTokenizer`` state dict → the port's on
    ``device``, its widths and version read off the weights."""
    from tts_tpu_torch.utils.convert import _to_numpy, hubert_tokenizer_from_jax_params

    state = {k: _to_numpy(v) for k, v in state.items()}
    w_ih = state["lstm.weight_ih_l0"]
    with torch.device("meta"):
        model = HubertTokenizer(hidden_size=w_ih.shape[0] // 4, input_size=w_ih.shape[1],
                                output_size=state["fc.weight"].shape[0],
                                version=1 if "intermediate.weight" in state else 0)
    return _load(model, hubert_tokenizer_from_jax_params(convert_hubert_tokenizer(state)),
                 resolve_device(device))


@torch.no_grad()
def semantic_tokens_from_audio(wav: np.ndarray, hubert: WavLM, tokenizer: HubertTokenizer,
                               output_layer: int = 9) -> np.ndarray:
    """wav ``[T]`` at 16 kHz → Bark semantic tokens ``[T']`` (reference
    ``inference_funcs.py generate_voice``: HuBERT's layer-9 features, then
    the tokenizer's argmax)."""
    dev = next(hubert.parameters()).device
    feats = hubert(torch.from_numpy(np.asarray(wav, np.float32))[None].to(dev),
                   output_layer=output_layer)
    return tokenizer.get_token(feats)[0].cpu().numpy()
