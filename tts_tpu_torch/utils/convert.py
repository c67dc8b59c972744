"""Weights into the port.

``flax_to_state_dict`` maps a flax param tree of the JAX package onto the
port's ``state_dict``. The port's modules carry the flax names, so the map is
a handful of rules rather than a table:

* ``name_<i>`` of a module list (``h_3``, ``resblocks_7``, ``flow_0``, …)
  → ``name.<i>``; the ``Conv_0`` / ``LayerNorm_0`` wrapper level of
  ``layers.common.Conv1d`` / ``LayerNorm`` is dropped;
* Dense ``kernel [in, out]`` → ``weight [out, in]``;
* Conv ``kernel [k, in, out]`` → ``weight [out, in, k]``, 2-D
  ``[kh, kw, in, out]`` → ``[out, in, kh, kw]``;
* the upsampling convs (``ups``) hold ``TorchConvTranspose1d``'s time-flipped
  ``[k, in, out]`` kernel → ``ConvTranspose1d`` ``[in, out, k]`` with ``k``
  flipped back;
* norm ``scale``/``shift`` → ``weight``/``bias`` (folded BatchNorm included);
  ``embedding`` → ``weight``; other leaves keep their names.

``reference_vits_state``, ``reference_glow_tts_state`` and
``reference_melgan_state`` write the port's weights in the reference
layout, the inverses of ``load_reference_vits``, ``load_reference_glow_tts``
and ``load_reference_vocoder``.

``load_reference_xtts`` / ``load_reference_vits`` / ``load_reference_glow_tts``
/ ``load_reference_vocoder`` read a reference-layout (coqui) checkpoint, map
it to the flax-layout tree with ``convert_xtts`` / ``convert_vits_generator``
/ ``convert_glow_tts`` / ``convert_hifigan_generator`` or
``convert_melgan_generator`` and from there into the port by the rules above.
Those converters and what they call are the port's own copy of the XTTS,
VITS, GlowTTS, HiFiGAN and MelGAN parts of ``tts_tpu/utils/convert.py``
(numpy only; the port imports
nothing of ``tts_tpu``): parity tests hold the copy equal to the JAX
package's converters, leaf for leaf (``tests/test_torch_host_copies.py``).
Two additions, for multi-language and deterministic-duration checkpoints,
which the JAX package's converter drops (ROADMAP.md F13): the stochastic
duration predictor's ``cond_lang`` and the whole ``use_sdp=False``
duration predictor (``convert_vits_dp``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LISTS = {
    "h", "attn", "to_q", "to_kv", "to_out", "ff1", "ff2",  # GPT, conditioning
    "ups", "cond_up", "resblocks", "convs1", "convs2", "convs",  # HiFiGAN
    "layer1", "layer2", "layer3", "layer4",  # speaker encoder
    "norm1", "norm2", "ffn",  # relative-position transformer
    "in_layer", "res_skip_layer",  # WaveNet
    "flow", "post_flow", "conv_sep", "conv_1x1",  # VITS flows, duration predictor
}
_WRAPPERS = {"Conv_0", "LayerNorm_0"}  # layers.common.Conv1d / LayerNorm in flax
_LEAF = {"scale": "weight", "shift": "bias", "embedding": "weight", "kernel": "weight"}
_INDEXED = re.compile(r"(.+)_(\d+)")


def _flatten(tree: Mapping, path: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, path + (key,))
        else:
            yield path + (key,), value


def _torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for name in path[:-1]:
        if name in _WRAPPERS:
            continue
        m = _INDEXED.fullmatch(name)
        parts += [m.group(1), m.group(2)] if m and m.group(1) in _LISTS else [name]
    return ".".join(parts + [_LEAF.get(path[-1], path[-1])])


def _torch_value(path: Tuple[str, ...], value) -> np.ndarray:
    a = np.asarray(value, dtype=np.float32)
    if path[-1] != "kernel":
        return a
    if a.ndim == 2:  # Dense
        return a.T
    if a.ndim == 3 and any(_INDEXED.fullmatch(p) and p.startswith("ups_") for p in path):
        return a.transpose(1, 2, 0)[:, :, ::-1]  # flipped [k, in, out] → [in, out, k]
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {a.ndim} at {'/'.join(path)}")


def flax_to_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the inner tree) → port state_dict
    entries, fp32, keys prefixed with ``prefix``."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    return {
        prefix + _torch_key(path): torch.from_numpy(np.array(_torch_value(path, v), order="C"))
        for path, v in _flatten(params)
    }


def xtts_from_jax_params(gpt_params: Mapping, decoder_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's XTTS ``(gpt_params, decoder_params)`` → the state_dict
    of ``tts_tpu_torch.models.xtts.model.Xtts``."""
    state = flax_to_state_dict(gpt_params, "gpt.")
    state.update(flax_to_state_dict(decoder_params, "hifigan_decoder."))
    return state


def vits_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VitsModule`` params (numpy or JAX arrays) → the
    state_dict of ``tts_tpu_torch.models.vits.model.VitsModule``."""
    return flax_to_state_dict(params)


def glow_tts_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``GlowTTSModule`` params → the state_dict of
    ``tts_tpu_torch.models.glow_tts.model.GlowTTSModule``."""
    return flax_to_state_dict(params)


def melgan_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MelGAN-family generator params → the state_dict of
    the port's generator (``vocoder/models/melgan_generator.py``); HiFiGAN's
    map by the same rules."""
    return flax_to_state_dict(params)



# ---------------------------------------------------------------------------
# Reference (coqui) XTTS state dict → flax-layout tree. Copied from
# ``tts_tpu/utils/convert.py``: the weight-norm and kernel-layout helpers
# (``:58-99``), ``convert_hifigan_generator`` (``:102``), the VITS converters
# (``:167-362``) and the XTTS converters (``:439-609``), unchanged.
# ---------------------------------------------------------------------------


def fold_weight_norm(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold ``weight_g``/``weight_v`` (old API) or
    ``parametrizations.weight.original{0,1}`` (new API) into plain weights."""
    out: Dict[str, np.ndarray] = {}
    handled = set()
    for key in list(state.keys()):
        if key.endswith("weight_v"):
            base = key[: -len("weight_v")]
            g, v = state[base + "weight_g"], state[base + "weight_v"]
            norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base + "weight"] = g * v / np.maximum(norm, 1e-12)
            handled |= {base + "weight_g", base + "weight_v"}
        elif key.endswith("parametrizations.weight.original1"):
            base = key[: -len("parametrizations.weight.original1")]
            g = state[base + "parametrizations.weight.original0"]
            v = state[key]
            norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base.rstrip(".") + ".weight"] = g * v / np.maximum(norm, 1e-12)
            handled |= {
                base + "parametrizations.weight.original0",
                base + "parametrizations.weight.original1",
            }
    for k, v in state.items():
        if k not in handled and k not in out:
            out[k] = v
    return out


def conv1d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 1, 0))


def convtranspose1d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w[:, :, ::-1], (2, 0, 1))


def conv2d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def convert_hifigan_generator(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference ``HifiganGenerator`` state dict → flax params for
    ``tts_tpu.vocoder.models.hifigan_generator.HifiganGenerator``."""
    state = fold_weight_norm(state)
    params: Dict[str, Any] = {}

    def put(path: str, leaf: Dict[str, np.ndarray]):
        node = params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    # conv_pre / conv_post (wrapped Conv1d -> child "Conv_0")
    put("conv_pre/Conv_0", {"kernel": conv1d_kernel(state["conv_pre.weight"]),
                            "bias": state["conv_pre.bias"]})
    post = {"kernel": conv1d_kernel(state["conv_post.weight"])}
    if "conv_post.bias" in state:
        post["bias"] = state["conv_post.bias"]
    put("conv_post/Conv_0", post)
    if "cond_layer.weight" in state:
        put("cond_layer", {
            "kernel": linear_kernel(state["cond_layer.weight"][:, :, 0]),
            "bias": state["cond_layer.bias"],
        })

    n_ups = len([k for k in state if k.startswith("ups.") and k.endswith(".weight")])
    for i in range(n_ups):
        put(f"ups_{i}", {
            "kernel": convtranspose1d_kernel(state[f"ups.{i}.weight"]),
            "bias": state[f"ups.{i}.bias"],
        })
        # per-upsample cond convs: "conds.{i}" in the XTTS decoder variant
        # (xtts/hifigan_decoder.py:261), "cond_in_each_up_layer.{i}" elsewhere
        for cname in (f"conds.{i}", f"cond_in_each_up_layer.{i}"):
            if f"{cname}.weight" in state:
                put(f"cond_up_{i}", {
                    "kernel": linear_kernel(state[f"{cname}.weight"][:, :, 0]),
                    "bias": state[f"{cname}.bias"],
                })
                break

    n_res = len({k.split(".")[1] for k in state if k.startswith("resblocks.")})
    for r in range(n_res):
        for conv_group in ("convs1", "convs2", "convs"):
            n_convs = len(
                {k.split(".")[3] for k in state if k.startswith(f"resblocks.{r}.{conv_group}.")}
            )
            for c in range(n_convs):
                w = state.get(f"resblocks.{r}.{conv_group}.{c}.weight")
                if w is None:
                    continue
                b = state[f"resblocks.{r}.{conv_group}.{c}.bias"]
                put(
                    f"resblocks_{r}/{conv_group}_{c}/Conv_0",
                    {"kernel": conv1d_kernel(w), "bias": b},
                )
    return {"params": params}


def _dense(state, key):
    """torch 1x1 Conv1d or Linear → flax Dense leaf."""
    w = state[f"{key}.weight"]
    if w.ndim == 3:  # [out, in, 1] conv1x1
        w = w[:, :, 0]
    leaf = {"kernel": linear_kernel(w)}
    if f"{key}.bias" in state:
        leaf["bias"] = state[f"{key}.bias"]
    return leaf


def _conv(state, key):
    """torch Conv1d → wrapped Conv1d (child "Conv_0")."""
    leaf = {"kernel": conv1d_kernel(state[f"{key}.weight"])}
    if f"{key}.bias" in state:
        leaf["bias"] = state[f"{key}.bias"]
    return {"Conv_0": leaf}


def _plain_conv(state, key):
    """torch Conv1d → bare nn.Conv leaf (no wrapper)."""
    leaf = {"kernel": conv1d_kernel(state[f"{key}.weight"])}
    if f"{key}.bias" in state:
        leaf["bias"] = state[f"{key}.bias"]
    return leaf


def _layernorm(state, key):
    """glow_tts LayerNorm (gamma/beta) or LayerNorm2 (weight/bias) → flax."""
    if f"{key}.gamma" in state:
        scale, bias = state[f"{key}.gamma"], state[f"{key}.beta"]
    else:
        scale, bias = state[f"{key}.weight"], state[f"{key}.bias"]
    return {"scale": scale.reshape(-1), "bias": bias.reshape(-1)}


def convert_rel_pos_transformer(state, prefix, num_layers):
    """Reference ``glow_tts/transformer.py`` RelativePositionTransformer →
    ``tts_tpu.layers.transformer.RelativePositionTransformer`` params."""
    p = {}
    for i in range(num_layers):
        attn = {
            "conv_q": _dense(state, f"{prefix}attn_layers.{i}.conv_q"),
            "conv_k": _dense(state, f"{prefix}attn_layers.{i}.conv_k"),
            "conv_v": _dense(state, f"{prefix}attn_layers.{i}.conv_v"),
            "conv_o": _dense(state, f"{prefix}attn_layers.{i}.conv_o"),
        }
        if f"{prefix}attn_layers.{i}.emb_rel_k" in state:
            attn["emb_rel_k"] = state[f"{prefix}attn_layers.{i}.emb_rel_k"]
            attn["emb_rel_v"] = state[f"{prefix}attn_layers.{i}.emb_rel_v"]
        p[f"attn_{i}"] = attn
        p[f"norm1_{i}"] = {"LayerNorm_0": _layernorm(state, f"{prefix}norm_layers_1.{i}")}
        p[f"ffn_{i}"] = {
            "conv_1": _conv(state, f"{prefix}ffn_layers.{i}.conv_1"),
            "conv_2": _conv(state, f"{prefix}ffn_layers.{i}.conv_2"),
        }
        p[f"norm2_{i}"] = {"LayerNorm_0": _layernorm(state, f"{prefix}norm_layers_2.{i}")}
    return p


def convert_wn(state, prefix, num_layers, has_cond=False):
    """Reference ``generic/wavenet.py`` WN → ``tts_tpu.layers.wavenet.WN``."""
    state = fold_weight_norm(state)
    p = {}
    for i in range(num_layers):
        p[f"in_layer_{i}"] = _conv(state, f"{prefix}in_layers.{i}")
        p[f"res_skip_layer_{i}"] = _dense(state, f"{prefix}res_skip_layers.{i}")
    if has_cond and f"{prefix}cond_layer.weight" in state:
        p["cond_layer"] = _dense(state, f"{prefix}cond_layer")
    return p


def convert_vits_text_encoder(state, num_layers=6):
    """Reference ``vits/networks.py`` TextEncoder →
    ``tts_tpu.models.vits.modules.TextEncoder``."""
    p = {
        "emb": {"embedding": state["emb.weight"]},
        "encoder": convert_rel_pos_transformer(state, "encoder.", num_layers),
        "proj": _dense(state, "proj"),
    }
    return {"params": p}


def convert_vits_posterior(state, num_layers=16, has_cond=False):
    """Reference PosteriorEncoder → ``tts_tpu`` PosteriorEncoder."""
    return {
        "params": {
            "pre": _dense(state, "pre"),
            "enc": convert_wn(state, "enc.", num_layers, has_cond),
            "proj": _dense(state, "proj"),
        }
    }


def convert_vits_flow(state, num_flows=4, num_layers=4, has_cond=False):
    """Reference ResidualCouplingBlocks → ``tts_tpu`` ResidualCouplingBlocks."""
    p = {}
    for i in range(num_flows):
        p[f"flow_{i}"] = {
            "pre": _dense(state, f"flows.{i}.pre"),
            "enc": convert_wn(state, f"flows.{i}.enc.", num_layers, has_cond),
            "post": _dense(state, f"flows.{i}.post"),
        }
    return {"params": p}


def _convert_dds(state, prefix, num_layers=3):
    """DilatedDepthSeparableConv (reference ``stochastic_duration_predictor.py:9``)."""
    p = {}
    for i in range(num_layers):
        p[f"conv_sep_{i}"] = _plain_conv(state, f"{prefix}convs_sep.{i}")
        p[f"conv_1x1_{i}"] = _dense(state, f"{prefix}convs_1x1.{i}")
        p[f"norm1_{i}"] = {"LayerNorm_0": _layernorm(state, f"{prefix}norms_1.{i}")}
        p[f"norm2_{i}"] = {"LayerNorm_0": _layernorm(state, f"{prefix}norms_2.{i}")}
    return p


def _convert_conv_flow(state, prefix):
    return {
        "pre": _dense(state, f"{prefix}pre"),
        "convs": _convert_dds(state, f"{prefix}convs."),
        "proj": _dense(state, f"{prefix}proj"),
    }


def _convert_affine_flow(state, prefix):
    return {
        "translation": state[f"{prefix}translation"].reshape(-1),
        "log_scale": state[f"{prefix}log_scale"].reshape(-1),
    }


def convert_vits_sdp(state, num_flows=4, has_cond=False):
    """StochasticDurationPredictor → ``tts_tpu`` SDP params."""
    p = {
        "pre": _dense(state, "pre"),
        "convs": _convert_dds(state, "convs."),
        "proj": _dense(state, "proj"),
        "post_pre": _dense(state, "post_pre"),
        "post_convs": _convert_dds(state, "post_convs."),
        "post_proj": _dense(state, "post_proj"),
        "flow_affine": _convert_affine_flow(state, "flows.0."),
        "post_flow_affine": _convert_affine_flow(state, "post_flows.0."),
    }
    for i in range(num_flows):
        p[f"flow_{i}"] = _convert_conv_flow(state, f"flows.{i + 1}.")
        p[f"post_flow_{i}"] = _convert_conv_flow(state, f"post_flows.{i + 1}.")
    if has_cond and "cond.weight" in state:
        p["cond"] = _dense(state, "cond")
    if "cond_lang.weight" in state:  # not in the JAX package's copy (F13)
        p["cond_lang"] = _dense(state, "cond_lang")
    return {"params": p}


def convert_vits_dp(state, has_cond=False):
    """Reference ``glow_tts/duration_predictor.py`` DurationPredictor (the
    ``use_sdp=False`` predictor) → the port's flax-layout names. Not in the
    JAX package (F13). Its ``DurationPredictor`` has no language input, so
    a checkpoint with ``cond_lang`` is refused."""
    if "cond_lang.weight" in state:
        raise NotImplementedError(
            "the deterministic duration predictor's language conditioning (cond_lang) has no "
            "counterpart in the JAX package's DurationPredictor and is not ported")
    p = {
        "conv_1": _conv(state, "conv_1"),
        "norm_1": {"LayerNorm_0": _layernorm(state, "norm_1")},
        "conv_2": _conv(state, "conv_2"),
        "norm_2": {"LayerNorm_0": _layernorm(state, "norm_2")},
        "proj": _plain_conv(state, "proj"),
    }
    if has_cond and "cond.weight" in state:
        p["cond"] = _dense(state, "cond")
    return {"params": p}


def _subdict(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def convert_vits_generator(state, args) -> Dict[str, Any]:
    """Full reference ``Vits`` state dict → ``tts_tpu`` VitsModule params.

    ``args`` is a ``VitsArgs`` (layer counts drive the name maps).
    """
    state = fold_weight_norm(state)
    has_cond = bool(args.use_speaker_embedding or args.use_d_vector_file)
    p = {
        "text_encoder": convert_vits_text_encoder(
            _subdict(state, "text_encoder."), num_layers=args.num_layers_text_encoder
        )["params"],
        "posterior_encoder": convert_vits_posterior(
            _subdict(state, "posterior_encoder."),
            num_layers=args.num_layers_posterior_encoder, has_cond=has_cond,
        )["params"],
        "flow": convert_vits_flow(
            _subdict(state, "flow."), num_flows=4,
            num_layers=args.num_layers_flow, has_cond=has_cond,
        )["params"],
        "waveform_decoder": convert_hifigan_generator(_subdict(state, "waveform_decoder."))[
            "params"
        ],
    }
    if args.use_sdp:
        p["duration_predictor"] = convert_vits_sdp(
            _subdict(state, "duration_predictor."), num_flows=4,
            has_cond=has_cond and args.condition_dp_on_speaker,
        )["params"]
    else:  # not in the JAX package's copy (F13)
        p["duration_predictor"] = convert_vits_dp(
            _subdict(state, "duration_predictor."),
            has_cond=has_cond and args.condition_dp_on_speaker,
        )["params"]
    if "emb_g.weight" in state:
        p["emb_g"] = {"embedding": state["emb_g.weight"]}
    if "emb_l.weight" in state:
        p["emb_l"] = {"embedding": state["emb_l.weight"]}
    return {"params": p}


# ---------------------------------------------------------------------------
# GlowTTS (copied from ``tts_tpu/utils/convert.py:363-436``) and the MelGAN
# family (``:777-806``), unchanged.
# ---------------------------------------------------------------------------


def convert_glow_duration_predictor(state, prefix=""):
    """glow_tts DurationPredictor → ``tts_tpu.layers.common.DurationPredictor``."""
    p = {
        "conv_1": _conv(state, f"{prefix}conv_1"),
        "norm_1": {"LayerNorm_0": _layernorm(state, f"{prefix}norm_1")},
        "conv_2": _conv(state, f"{prefix}conv_2"),
        "norm_2": {"LayerNorm_0": _layernorm(state, f"{prefix}norm_2")},
        "proj": _plain_conv(state, f"{prefix}proj"),
    }
    if f"{prefix}cond.weight" in state:
        p["cond"] = _dense(state, f"{prefix}cond")
    return p


def convert_glow_prenet(state, prefix, num_layers=3):
    """ResidualConv1dLayerNormBlock → ``ConvLayerNormBlock``."""
    p = {}
    for i in range(num_layers):
        p[f"conv_{i}"] = _conv(state, f"{prefix}conv_layers.{i}")
        p[f"norm_{i}"] = {"LayerNorm_0": _layernorm(state, f"{prefix}norm_layers.{i}")}
    p["proj"] = _plain_conv(state, f"{prefix}proj")
    return p


def convert_glow_decoder(state, prefix="", num_flow_blocks=12, num_coupling_layers=4):
    """glow_tts Decoder (flows list) → ``tts_tpu.layers.glow.GlowDecoder``."""
    state = fold_weight_norm(state)
    p = {}
    for k in range(num_flow_blocks):
        base = 3 * k
        p[f"actnorm_{k}"] = {
            "logs": state[f"{prefix}flows.{base}.logs"].reshape(-1),
            "bias": state[f"{prefix}flows.{base}.bias"].reshape(-1),
        }
        p[f"invconv_{k}"] = {"weight": state[f"{prefix}flows.{base + 1}.weight"]}
        cpl = f"{prefix}flows.{base + 2}."
        p[f"coupling_{k}"] = {
            "start": _dense(state, f"{cpl}start"),
            "wn": convert_wn(state, f"{cpl}wn.", num_coupling_layers, has_cond=True),
            "end": _dense(state, f"{cpl}end"),
        }
    return p


def convert_glow_tts(state, config) -> Dict[str, Any]:
    """Full reference ``GlowTTS`` state dict → ``tts_tpu`` GlowTTSModule."""
    state = fold_weight_norm(state)
    enc = {
        "emb": {"embedding": state["encoder.emb.weight"]},
        "encoder": convert_rel_pos_transformer(
            state, "encoder.encoder.", config.encoder_params.get("num_layers", 6)
        ),
        "proj_m": _dense(state, "encoder.proj_m"),
        "duration_predictor": convert_glow_duration_predictor(
            state, "encoder.duration_predictor."
        ),
    }
    if config.use_encoder_prenet:
        enc["prenet"] = convert_glow_prenet(state, "encoder.prenet.")
    if not config.mean_only and "encoder.proj_s.weight" in state:
        enc["proj_s"] = _dense(state, "encoder.proj_s")
    p = {
        "enc": enc,
        "dec": convert_glow_decoder(
            state, "decoder.", config.num_flow_blocks_dec, config.num_block_layers
        ),
    }
    if "emb_g.weight" in state:
        p["emb_g"] = {"embedding": state["emb_g.weight"]}
    return {"params": p}


def _convtranspose(state, key):
    leaf = {"kernel": convtranspose1d_kernel(state[f"{key}.weight"])}
    if f"{key}.bias" in state:
        leaf["bias"] = state[f"{key}.bias"]
    return leaf


def convert_melgan_generator(state, num_upsample_stages, num_res_blocks=3):
    """Reference MelganGenerator Sequential → flax params.

    Sequential layout: [pad, conv_pre, (lrelu, convT, resstack)*N, lrelu,
    pad, conv_post, tanh] → conv indices 1, 3+3i, and 2+3N+2."""
    state = fold_weight_norm(state)
    p = {"conv_pre": _plain_conv(state, "layers.1")}
    for i in range(num_upsample_stages):
        up = 3 + 3 * i
        p[f"ups_{i}"] = _convtranspose(state, f"layers.{up}")
        stack = {}
        for j in range(num_res_blocks):
            stack[f"block{j}_conv1"] = _plain_conv(state, f"layers.{up + 1}.blocks.{j}.2")
            stack[f"block{j}_conv2"] = _plain_conv(state, f"layers.{up + 1}.blocks.{j}.4")
            stack[f"shortcut{j}"] = _plain_conv(state, f"layers.{up + 1}.shortcuts.{j}")
        p[f"res_{i}"] = stack
    final = 2 + 3 * num_upsample_stages + 2
    p["conv_post"] = _plain_conv(state, f"layers.{final}")
    return {"params": p}


def _qkv_interleaved_dense(state, key, heads):
    """Conditioning-encoder qkv conv1x1 → flax Dense.

    The reference QKVAttention (latent_encoder.py:43) lays out the 3C output
    channels head-major ``[H, (q,k,v), dh]``; our AttentionBlock reshapes
    ``[.., 3, H, dh]`` — permute out-channels accordingly."""
    w = state[f"{key}.weight"][:, :, 0]  # [3D, D]
    b = state[f"{key}.bias"]
    d = w.shape[1]
    dh = d // heads
    w = w.reshape(heads, 3, dh, d).transpose(1, 0, 2, 3).reshape(3 * d, d)
    b = b.reshape(heads, 3, dh).transpose(1, 0, 2).reshape(3 * d)
    return {"kernel": linear_kernel(w), "bias": b}


def convert_conditioning_encoder(state, prefix="", heads=16, attn_blocks=6):
    """ConditioningEncoder (reference latent_encoder.py:119)."""
    p = {"init": _dense(state, f"{prefix}init")}
    for i in range(attn_blocks):
        k = f"{prefix}attn.{i}"
        p[f"attn_{i}"] = {
            "norm": _layernorm(state, f"{k}.norm"),
            "qkv": _qkv_interleaved_dense(state, f"{k}.qkv", heads),
            "proj_out": _dense(state, f"{k}.proj_out"),
        }
    return p


def convert_perceiver_resampler(state, prefix="", depth=2):
    """PerceiverResampler (reference perceiver_encoder.py:225).

    Reference FeedForward is ``Sequential(Linear, GEGLU, Linear)`` →
    torch keys ``layers.{i}.1.{0,2}``; attention projections are bias-free."""
    p = {"latents": state[f"{prefix}latents"], "norm_gamma": state[f"{prefix}norm.gamma"]}
    for i in range(depth):
        a = f"{prefix}layers.{i}.0"
        f = f"{prefix}layers.{i}.1"
        p[f"to_q_{i}"] = {"kernel": linear_kernel(state[f"{a}.to_q.weight"])}
        p[f"to_kv_{i}"] = {"kernel": linear_kernel(state[f"{a}.to_kv.weight"])}
        p[f"to_out_{i}"] = {"kernel": linear_kernel(state[f"{a}.to_out.weight"])}
        p[f"ff1_{i}"] = _dense(state, f"{f}.0")
        p[f"ff2_{i}"] = _dense(state, f"{f}.2")
    return p


def convert_gpt2_core(state, prefix="", layers=30):
    """HF GPT2Model → GPT2Core.  HF Conv1D weights are already ``[in, out]``
    (no transpose); gate order q,k,v matches our ``jnp.split``."""

    def hf_dense(key):
        leaf = {"kernel": state[f"{key}.weight"]}
        if f"{key}.bias" in state:
            leaf["bias"] = state[f"{key}.bias"]
        return leaf

    p = {"ln_f": _layernorm(state, f"{prefix}ln_f")}
    for i in range(layers):
        k = f"{prefix}h.{i}"
        p[f"h_{i}"] = {
            "ln_1": _layernorm(state, f"{k}.ln_1"),
            "ln_2": _layernorm(state, f"{k}.ln_2"),
            "attn": {"c_attn": hf_dense(f"{k}.attn.c_attn"), "c_proj": hf_dense(f"{k}.attn.c_proj")},
            "mlp_fc": hf_dense(f"{k}.mlp.c_fc"),
            "mlp_proj": hf_dense(f"{k}.mlp.c_proj"),
        }
    return p


def convert_xtts_gpt(
    state,
    layers=30,
    heads=16,
    cond_attn_blocks=6,
    perceiver_depth=2,
    use_perceiver=True,
    prefix="gpt.",
):
    """Full XTTS GPT stack (reference gpt.py:88 GPT).  ``state`` is the
    checkpoint dict; ``prefix`` is where the GPT lives (``"gpt."`` inside a
    full XTTS checkpoint, ``""`` for a bare GPT state dict)."""
    s = _subdict(state, prefix) if prefix else dict(state)
    p = {
        "conditioning_encoder": convert_conditioning_encoder(
            s, "conditioning_encoder.", heads, cond_attn_blocks
        ),
        "text_embedding": {"embedding": s["text_embedding.weight"]},
        "mel_embedding": {"embedding": s["mel_embedding.weight"]},
        "text_pos_embedding": s["text_pos_embedding.emb.weight"],
        "mel_pos_embedding": s["mel_pos_embedding.emb.weight"],
        "gpt": convert_gpt2_core(s, "gpt.", layers),
        "final_norm": _layernorm(s, "final_norm"),
        "text_head": _dense(s, "text_head"),
        "mel_head": _dense(s, "mel_head"),
    }
    if use_perceiver:
        p["conditioning_perceiver"] = convert_perceiver_resampler(
            s, "conditioning_perceiver.", perceiver_depth
        )
    return {"params": p}


def _fold_bn(state, key, eps=1e-5):
    """Eval-mode BatchNorm → elementwise affine (``_Norm2d`` "folded")."""
    mean, var = state[f"{key}.running_mean"], state[f"{key}.running_var"]
    w = state.get(f"{key}.weight", np.ones_like(var))
    b = state.get(f"{key}.bias", np.zeros_like(mean))
    scale = w / np.sqrt(var + eps)
    return {"scale": scale, "shift": b - mean * scale}


def _conv2d_tm(state, key):
    """torch Conv2d over (mel, time) → our Conv over (time, mel): swap the
    kernel's spatial axes on top of the layout transpose."""
    leaf = {"kernel": conv2d_kernel(state[f"{key}.weight"]).transpose(1, 0, 2, 3)}
    if f"{key}.bias" in state:
        leaf["bias"] = state[f"{key}.bias"]
    return leaf


def convert_resnet_speaker_encoder(state, prefix="", layers=(3, 4, 6, 3)):
    """ResNetSpeakerEncoder → flax params (use with ``norm_type="folded"``)."""
    s = _subdict(state, prefix) if prefix else dict(state)
    p = {
        "conv1": _conv2d_tm(s, "conv1"),
        "bn1": _fold_bn(s, "bn1"),
        "attn_conv1": _plain_conv(s, "attention.0"),
        "attn_bn": _fold_bn(s, "attention.2"),
        "attn_conv2": _plain_conv(s, "attention.3"),
        "fc": _dense(s, "fc"),
    }
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            k = f"layer{li + 1}.{bi}"
            blk = {
                "conv1": _conv2d_tm(s, f"{k}.conv1"),
                "bn1": _fold_bn(s, f"{k}.bn1"),
                "conv2": _conv2d_tm(s, f"{k}.conv2"),
                "bn2": _fold_bn(s, f"{k}.bn2"),
                "se": {"fc1": _dense(s, f"{k}.se.fc.0"), "fc2": _dense(s, f"{k}.se.fc.2")},
            }
            if f"{k}.downsample.0.weight" in s:
                blk["downsample_conv"] = _conv2d_tm(s, f"{k}.downsample.0")
                blk["downsample_bn"] = _fold_bn(s, f"{k}.downsample.1")
            p[f"layer{li + 1}_{bi}"] = blk
    return p


def convert_hifi_decoder(state, prefix="hifigan_decoder."):
    """XTTS HifiDecoder (waveform decoder + speaker encoder)."""
    s = _subdict(state, prefix) if prefix else dict(state)
    return {
        "params": {
            "waveform_decoder": convert_hifigan_generator(
                _subdict(s, "waveform_decoder.")
            )["params"],
            "speaker_encoder": convert_resnet_speaker_encoder(s, "speaker_encoder."),
        }
    }


def convert_xtts(state, layers=30, heads=16):
    """Full XTTS v2 checkpoint → (gpt_params, decoder_params) pair for
    :class:`tts_tpu.models.xtts.model.Xtts`."""
    gpt_params = convert_xtts_gpt(state, layers=layers, heads=heads, prefix="gpt.")
    decoder_params = convert_hifi_decoder(state, prefix="hifigan_decoder.")
    return gpt_params, decoder_params


def _to_numpy(value: Any):
    if isinstance(value, torch.Tensor):
        return value.float().numpy() if value.is_floating_point() else value.numpy()
    return np.asarray(value)


def load_reference_xtts(path: str, layers: int = 30, heads: int = 16) -> Dict[str, torch.Tensor]:
    """Reference-layout XTTS ``model.pth`` → port state_dict (plus
    ``mel_stats`` when the checkpoint has them)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    state = {k: _to_numpy(v) for k, v in state.items()}
    mel_stats = state.pop("mel_stats", None)
    gpt_params, decoder_params = convert_xtts(state, layers=layers, heads=heads)
    out = xtts_from_jax_params(gpt_params, decoder_params)
    if mel_stats is not None:
        out["mel_stats"] = torch.from_numpy(np.asarray(mel_stats, np.float32))
    return out


def reference_vits_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of ``VitsModule`` in the reference's (coqui) names and
    layouts, weight norm folded: 1x1 convolutions for the linear layers,
    ``gamma``/``beta`` norms, the stochastic predictor's flows numbered
    after its affine flow. :func:`load_reference_vits` maps it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = re.sub(r"^text_encoder\.encoder\.(attn|ffn)\.", r"text_encoder.encoder.\1_layers.", key)
        k = re.sub(r"encoder\.norm([12])\.(\d+)\.", r"encoder.norm_layers_\1.\2.", k)
        k = re.sub(r"\.(in_layer|res_skip_layer)\.", r".\1s.", k)
        k = re.sub(r"^flow\.flow\.", "flow.flows.", k)
        k = re.sub(r"^duration_predictor\.(post_)?flow_affine\.",
                   lambda m: f"duration_predictor.{m.group(1) or ''}flows.0.", k)
        k = re.sub(r"^duration_predictor\.(post_)?flow\.(\d+)\.",
                   lambda m: f"duration_predictor.{m.group(1) or ''}flows.{int(m.group(2)) + 1}.", k)
        k = re.sub(r"\.conv_(sep|1x1)\.", r".convs_\1.", k)
        k = re.sub(r"convs\.norm([12])\.", r"convs.norms_\1.", k)
        if re.search(r"(norm_layers_\d\.\d+|norms_\d\.\d+|norm_[12])\.(weight|bias)$", k):
            k = k[: -len("weight")] + "gamma" if k.endswith("weight") else k[: -len("bias")] + "beta"
        if v.ndim == 2 and not key.endswith(("emb.weight", "emb_g.weight", "emb_l.weight")):
            v = v[:, :, None]
        if k.endswith(("translation", "log_scale")):
            v = v[:, None]
        out[k] = v
    return out


def load_reference_vits(state: Mapping, args) -> Dict[str, torch.Tensor]:
    """A reference-layout VITS state dict (tensors or arrays) → the
    state_dict of ``VitsModule``; ``args`` is the model's ``VitsArgs``."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    return vits_from_jax_params(convert_vits_generator(state, args))


def load_reference_glow_tts(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout GlowTTS state dict (tensors or arrays) → the
    state_dict of ``GlowTTSModule``; ``config`` is the model's
    ``GlowTTSConfig``."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    return glow_tts_from_jax_params(convert_glow_tts(state, config))


def _strip_prefix(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """``state`` without ``prefix``, keeping only the keys that have it,
    when any does (a GAN checkpoint's ``model_g.`` generator)."""
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return state


def load_reference_vocoder(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout vocoder checkpoint (its generator under
    ``model_g.``, or bare) → the state_dict of the generator that
    ``config.generator_model`` names (the dispatch of
    ``tts_tpu/utils/zoo_convert.py:68-80``)."""
    state = _strip_prefix({k: _to_numpy(v) for k, v in state.items()}, "model_g.")
    name = config.generator_model.lower()
    if name == "hifigan_generator":
        return flax_to_state_dict(convert_hifigan_generator(state))
    if name in ("melgan_generator", "multiband_melgan_generator", "fullband_melgan_generator"):
        gp = config.generator_model_params
        return melgan_from_jax_params(convert_melgan_generator(
            state, num_upsample_stages=len(gp["upsample_factors"]),
            num_res_blocks=gp.get("num_res_blocks", 3)))
    raise NotImplementedError(f"no converter for the vocoder generator {name!r} in "
                              f"tts_tpu_torch (ROADMAP.md item 16)")


def _reference_key(key: str, rules) -> str:
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


_GLOW_RULES = (
    (r"^enc\.", "encoder."),
    (r"^dec\.", "decoder."),
    (r"^encoder\.encoder\.(attn|ffn)\.", r"encoder.encoder.\1_layers."),
    (r"^encoder\.encoder\.norm([12])\.", r"encoder.encoder.norm_layers_\1."),
    (r"^encoder\.prenet\.conv_(\d+)\.", r"encoder.prenet.conv_layers.\1."),
    (r"^encoder\.prenet\.norm_(\d+)\.", r"encoder.prenet.norm_layers.\1."),
    (r"\.(in_layer|res_skip_layer)\.", r".\1s."),
    (r"^decoder\.actnorm_(\d+)\.", lambda m: f"decoder.flows.{3 * int(m.group(1))}."),
    (r"^decoder\.invconv_(\d+)\.", lambda m: f"decoder.flows.{3 * int(m.group(1)) + 1}."),
    (r"^decoder\.coupling_(\d+)\.", lambda m: f"decoder.flows.{3 * int(m.group(1)) + 2}."),
)


def reference_glow_tts_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of ``GlowTTSModule`` in the reference's (coqui) names
    and layouts, weight norm folded: 1x1 convolutions for the linear layers,
    ``gamma``/``beta`` norms ``[1, C, 1]``, ``ActNorm`` terms ``[1, C, 1]``,
    the flows numbered in one list. :func:`load_reference_glow_tts` maps it
    back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _GLOW_RULES)
        if re.search(r"norm(_layers(_[12])?\.\d+|_[12])\.(weight|bias)$", k):
            k = k[: -len("weight")] + "gamma" if k.endswith("weight") else k[: -len("bias")] + "beta"
            v = v[None, :, None]
        elif re.search(r"decoder\.flows\.\d+\.(logs|bias)$", k) and v.ndim == 1:
            v = v[None, :, None]
        elif v.ndim == 2 and not key.endswith(("emb.weight", "emb_g.weight")) \
                and ".invconv_" not in key:
            v = v[:, :, None]
        out[k] = v
    return out


def reference_melgan_state(state: Mapping[str, torch.Tensor],
                           prefix: str = "model_g.") -> Dict[str, np.ndarray]:
    """The state_dict of a MelGAN-family generator in the reference's
    ``Sequential`` names (``layers.<i>``), under ``prefix`` as a GAN
    checkpoint holds its generator. :func:`load_reference_vocoder` maps it
    back."""
    n_up = len({k.split(".")[1] for k in state if k.startswith("ups.")})
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = key
        k = re.sub(r"^conv_pre\.", "layers.1.", k)
        k = re.sub(r"^conv_post\.", f"layers.{3 * n_up + 4}.", k)
        k = re.sub(r"^ups\.(\d+)\.", lambda m: f"layers.{3 + 3 * int(m.group(1))}.", k)
        k = re.sub(r"^res_(\d+)\.block(\d+)_conv([12])\.",
                   lambda m: f"layers.{4 + 3 * int(m.group(1))}.blocks.{m.group(2)}."
                             f"{2 if m.group(3) == '1' else 4}.", k)
        k = re.sub(r"^res_(\d+)\.shortcut(\d+)\.",
                   lambda m: f"layers.{4 + 3 * int(m.group(1))}.shortcuts.{m.group(2)}.", k)
        out[prefix + k] = v
    return out
