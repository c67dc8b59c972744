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
* the upsampling convs (``ups``, and UnivNet's ``upsample``) hold
  ``TorchConvTranspose1d``'s time-flipped ``[k, in, out]`` kernel →
  ``ConvTranspose1d`` ``[in, out, k]`` with ``k`` flipped back;
* norm ``scale``/``shift`` → ``weight``/``bias`` (folded BatchNorm included);
  ``embedding`` → ``weight``; other leaves keep their names;
* an int8 kernel of the JAX package's ``quantize_int8`` (``{"int8",
  "scale"}``) → the int8 module's ``weight_int8`` in the layout above (bit
  for bit) and its per-output-channel ``scale [out]``
  (``tts_tpu_torch.ops.quant``), so quantized XTTS, Tortoise and Bark trees
  carry over as they are.

``tacotron2_from_jax_params`` adds one rule for Tacotron2: flax's LSTM
cells, eight Denses each, are packed into torch's LSTM weights;
``overflow_from_jax_params`` packs Overflow's and NeuralHMM's the same way,
and so does ``speaker_encoder_from_jax_params`` the LSTM speaker encoder's;
``forward_tts_from_jax_params`` packs flax's attention Denses
(``query``/``key``/``value`` ``[C, H, dh]``, ``out`` ``[H, dh, C]``) into
``in_proj_weight`` ``[3C, C]`` and ``out_proj``, and drops the
training-only aligner, and ``align_tts_from_jax_params`` does the same for
AlignTTS, dropping its MDN head; ``delightful_tts_from_jax_params`` carries
DelightfulTTS's acoustic and joint vocoder trees without the training-only
aligner and prosody encoders. ``parallel_wavegan_from_jax_params``,
``univnet_from_jax_params`` and ``wavegrad_from_jax_params`` are the generic
rules; ``wavernn_from_jax_params`` packs flax's ``GRUCell`` Denses into
``nn.GRUCell`` (``bias_hh`` zeros for ``r`` and ``z``, ``hn``'s bias for
``n``). The vocoders' discriminators
(``vocoder_discriminator_from_jax_params``, every family) take the
generic rules; ``vocoder_train_state_from_jax_params`` carries a JAX
vocoder train state (``{"gen", "disc"}`` or ``{"model"}``) into the groups
of the port's trainer checkpoints.

``reference_vits_state``, ``reference_glow_tts_state``,
``reference_melgan_state``, ``reference_tacotron2_state``,
``reference_speaker_encoder_state``, ``reference_forward_tts_state``,
``reference_overflow_state``, ``reference_parallel_wavegan_state``,
``reference_univnet_state``, ``reference_wavegrad_state`` and
``reference_wavernn_state`` write the port's weights in the reference
layout, the inverses of ``load_reference_vits``,
``load_reference_glow_tts``, ``load_reference_vocoder``,
``load_reference_tacotron2``, ``load_reference_speaker_encoder``,
``load_reference_forward_tts`` and ``load_reference_overflow``.

``load_reference_xtts`` / ``load_reference_vits`` / ``load_reference_glow_tts``
/ ``load_reference_vocoder`` / ``load_reference_tacotron2`` read a
reference-layout (coqui) checkpoint, map it to the flax-layout tree with
``convert_xtts`` / ``convert_vits_generator`` / ``convert_glow_tts`` /
``convert_hifigan_generator``, ``convert_melgan_generator``,
``convert_parallel_wavegan_generator``, ``convert_univnet_generator``,
``convert_wavegrad`` or ``convert_wavernn`` / ``convert_tacotron2`` and from
there into the port by the rules above. Those converters and what they call
are the port's own copy of the XTTS, VITS, GlowTTS, vocoder, Tacotron2,
speaker encoder, ForwardTTS and Overflow parts of
``tts_tpu/utils/convert.py`` (numpy only; the port imports nothing of
``tts_tpu``): parity tests hold the copy equal to the JAX package's
converters, leaf for leaf (``tests/test_torch_host_copies.py``).
``convert_fairseq_vits`` renames a fairseq MMS VITS checkpoint into the
coqui layout (``rehash_fairseq_vits``, the JAX package's rename list) and
loads it as ``load_reference_vits`` does; nothing loads an MMS model
directory yet (ROADMAP.md F35).
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


_QUANTIZED = {"int8", "scale"}  # an int8 kernel of the JAX package's ``quantize_int8``


def _flatten(tree: Mapping, path: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping) and set(value) != _QUANTIZED:
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


def _torch_value(path: Tuple[str, ...], value, dtype=np.float32) -> np.ndarray:
    a = np.asarray(value, dtype=dtype)
    if path[-1] != "kernel":
        return a
    if a.ndim == 2:  # Dense
        return a.T
    if a.ndim == 3 and (path[-2] == "upsample"
                        or any(_INDEXED.fullmatch(p) and p.startswith("ups_") for p in path)):
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
    state = {}
    for path, v in _flatten(params):
        key = prefix + _torch_key(path)
        if isinstance(v, Mapping):  # int8 kernel → the int8 module's buffers
            base = key[: -len("weight")]
            state[base + "weight_int8"] = torch.from_numpy(
                np.array(_torch_value(path, v["int8"], np.int8), order="C"))
            state[base + "scale"] = torch.from_numpy(np.array(v["scale"], np.float32).reshape(-1))
        else:
            state[key] = torch.from_numpy(np.array(_torch_value(path, v), order="C"))
    return state


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


def vits_discriminator_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VitsDiscriminator`` params (``disc_s``,
    ``disc_p{p}``) → the state_dict of
    ``tts_tpu_torch.models.vits.modules.VitsDiscriminator``: flax's 2-D
    kernels ``[k, 1, in, out]`` become ``[out, in, k, 1]``, the 1-D ones
    ``[out, in / groups, k]``."""
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


_LSTM_GATES = ("i", "f", "g", "o")


def _pack_lstm(cell: Mapping, suffix: str = "") -> Dict[str, np.ndarray]:
    """flax ``OptimizedLSTMCell`` params (``ii/if/ig/io`` input Denses
    without bias, ``hi/hf/hg/ho`` hidden Denses with bias) → torch LSTM
    ``weight_ih``/``weight_hh`` ``[4H, in]`` in gate order i, f, g, o, the
    bias on the hidden side and zeros on the input side."""
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"], np.float32).T
                           for g in _LSTM_GATES])
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"], np.float32).T
                           for g in _LSTM_GATES])
    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32) for g in _LSTM_GATES])
    return {f"weight_ih{suffix}": w_ih, f"weight_hh{suffix}": w_hh,
            f"bias_ih{suffix}": np.zeros_like(b_hh), f"bias_hh{suffix}": b_hh}


# flax cells that become (a direction of) a whole-sequence nn.LSTM or nn.GRU:
# an encoder's two LSTM directions, Capacitron's LSTMs, the GST reference
# encoder's GRU and a CBHG's two GRU directions (flax names them GRUCell_0/_1)
_RNN_NAMES = {"lstm_fwd": ("lstm", "_l0"), "lstm_bwd": ("lstm", "_l0_reverse"),
              "lstm": ("lstm", "_l0"), "gru": ("gru", "_l0"),
              "GRUCell_0": ("gru", "_l0"), "GRUCell_1": ("gru", "_l0_reverse")}


def _carry_lstms(params: Mapping, drop: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """The generic rules, with each flax LSTM or GRU cell packed: the cells
    of :data:`_RNN_NAMES` into (a direction of) an ``nn.LSTM`` or
    ``nn.GRU``, any other LSTM cell into ``nn.LSTMCell`` weights under its
    own name. Subtrees named in ``drop`` are left out."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    lstms: Dict[str, np.ndarray] = {}

    def split(tree: Mapping, path: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for key, value in tree.items():
            if key in drop:
                continue
            if isinstance(value, Mapping) and ("ii" in value or "ir" in value):
                name, suffix = _RNN_NAMES.get(key, (key, ""))
                pack = _pack_lstm(value, suffix) if "ii" in value else _pack_gru(value, suffix)
                lstms.update({".".join(path + (name, leaf)): w for leaf, w in pack.items()})
            else:
                out[key] = split(value, path + (key,)) if isinstance(value, Mapping) else value
        return out

    state = flax_to_state_dict(split(params, ()))
    state.update({k: torch.from_numpy(v) for k, v in lstms.items()})
    return state


def tacotron2_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Tacotron2Module`` params (or those of one of its
    layers) → the state_dict of the port's module: the generic rules, with
    each flax LSTM cell packed (:func:`_carry_lstms`), the encoder's into
    one bidirectional ``lstm``, the decoder's ``attention_rnn`` and
    ``decoder_rnn`` into ``nn.LSTMCell`` weights, the GST's and Capacitron's
    recurrent cells into an ``nn.GRU`` and ``nn.LSTM``s. The DDC coarse
    decoder (``coarse_decoder_cell``), which only training runs, is
    dropped."""
    return _carry_lstms(params, drop=("coarse_decoder_cell",))


def gst_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``GST`` params → the state_dict of the port's
    (``layers/tacotron_v1.py``): the generic rules, the reference encoder's
    ``GRUCell`` packed into an ``nn.GRU``."""
    return _carry_lstms(params)


def capacitron_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``CapacitronVAE`` params → the state_dict of the
    port's (``layers/capacitron.py``): the generic rules, the reference
    encoder's and the text summary's LSTM cells packed into ``nn.LSTM``s."""
    return _carry_lstms(params)


def tacotron_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Tacotron v1 ``TacotronModule`` params → the
    state_dict of the port's (``models/tacotron2/tacotron_v1.py``): the
    generic rules, each CBHG's two ``GRUCell``s packed into one
    bidirectional ``nn.GRU``, the decoder cell's LSTMs as in
    :func:`tacotron2_from_jax_params`."""
    return _carry_lstms(params)


def overflow_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``NeuralhmmTTSModule`` params (Overflow's or
    NeuralHMM's, or those of one of its layers) → the state_dict of the
    port's module: the generic rules, with the encoder's two LSTM cells
    packed into one bidirectional ``lstm`` and the ``memory_rnn`` cell into
    ``nn.LSTMCell`` weights (:func:`_carry_lstms`)."""
    return _carry_lstms(params)


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


# fairseq MMS VITS (copied from tts_tpu/utils/convert.py:720-770; reference
# TTS/tts/utils/fairseq.py:4 + vits.py:1727). fairseq name → coqui name,
# applied longest prefix first, so the order of the list matters. fairseq
# keeps the trivial flip flows at odd indices, so the affine flows 0/2/4/6
# renumber to 0..3; the SDP flow lists (0,1,3,5,7) renumber to 0..4 with the
# first flow's m/logs becoming translation/log_scale.
_FAIRSEQ_RENAMES = [
    ("dp.flows.0.m", "duration_predictor.flows.0.translation"),
    ("dp.flows.0.logs", "duration_predictor.flows.0.log_scale"),
    ("dp.flows.1.", "duration_predictor.flows.1."),
    ("dp.flows.3.", "duration_predictor.flows.2."),
    ("dp.flows.5.", "duration_predictor.flows.3."),
    ("dp.flows.7.", "duration_predictor.flows.4."),
    ("dp.post_flows.0.m", "duration_predictor.post_flows.0.translation"),
    ("dp.post_flows.0.logs", "duration_predictor.post_flows.0.log_scale"),
    ("dp.post_flows.1.", "duration_predictor.post_flows.1."),
    ("dp.post_flows.3.", "duration_predictor.post_flows.2."),
    ("dp.post_flows.5.", "duration_predictor.post_flows.3."),
    ("dp.post_flows.7.", "duration_predictor.post_flows.4."),
    ("dp.", "duration_predictor."),
    ("flow.flows.2.", "flow.flows.1."),
    ("flow.flows.4.", "flow.flows.2."),
    ("flow.flows.6.", "flow.flows.3."),
    ("enc_p.", "text_encoder."),
    ("enc_q.", "posterior_encoder."),
    ("dec.", "waveform_decoder."),
]


def rehash_fairseq_vits(state):
    """Rename a fairseq MMS VITS state dict to the coqui-VITS layout that
    :func:`convert_vits_generator` consumes."""
    out = {}
    for k, v in state.items():
        for old, new in _FAIRSEQ_RENAMES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def convert_fairseq_vits(state, args) -> Dict[str, torch.Tensor]:
    """A fairseq MMS VITS checkpoint's ``"model"`` dict (``G_100000.pth``)
    → the state_dict of the port's ``VitsModule``: renamed into the coqui
    layout, then :func:`load_reference_vits`. The JAX package's
    ``convert_fairseq_vits`` returns the flax params on the way."""
    return load_reference_vits(rehash_fairseq_vits(state), args)


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
    use_perceiver=None,
    prefix="gpt.",
):
    """Full XTTS GPT stack (reference gpt.py:88 GPT).  ``state`` is the
    checkpoint dict; ``prefix`` is where the GPT lives (``"gpt."`` inside a
    full XTTS checkpoint, ``""`` for a bare GPT state dict).
    ``use_perceiver=None`` reads the layout from the checkpoint: one without
    ``conditioning_perceiver.*`` (XTTS v1) converts without the perceiver.
    The JAX package's copy defaults to ``True`` and raises ``KeyError`` on a
    v1 checkpoint, in ``convert_xtts`` too (ROADMAP.md F46)."""
    s = _subdict(state, prefix) if prefix else dict(state)
    if use_perceiver is None:
        use_perceiver = "conditioning_perceiver.latents" in s
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
    """Full XTTS checkpoint → (gpt_params, decoder_params) pair for
    :class:`tts_tpu.models.xtts.model.Xtts`."""
    gpt_params = convert_xtts_gpt(state, layers=layers, heads=heads, prefix="gpt.")
    decoder_params = convert_hifi_decoder(state, prefix="hifigan_decoder.")
    return gpt_params, decoder_params


# ---------------------------------------------------------------------------
# Tacotron2 (copied from ``tts_tpu/utils/convert.py:616-751``) and its GST and
# Capacitron layers (``:1859-1903``), unchanged.
# ---------------------------------------------------------------------------


def _lstm_cell(state, prefix, suffix=""):
    """torch LSTM(Cell) gates [i,f,g,o] → flax OptimizedLSTMCell params
    (``ii/if/ig/io`` bias-free input Dense + ``hi/hf/hg/ho`` biased hidden
    Dense; the two torch biases sum onto the hidden side)."""
    wi = state[f"{prefix}.weight_ih{suffix}"]
    wh = state[f"{prefix}.weight_hh{suffix}"]
    bi = state[f"{prefix}.bias_ih{suffix}"]
    bh = state[f"{prefix}.bias_hh{suffix}"]
    H = wh.shape[1]
    p = {}
    for gidx, g in enumerate(("i", "f", "g", "o")):
        sl = slice(gidx * H, (gidx + 1) * H)
        p[f"i{g}"] = {"kernel": linear_kernel(wi[sl])}
        p[f"h{g}"] = {"kernel": linear_kernel(wh[sl]), "bias": bi[sl] + bh[sl]}
    return p


def _conv_bn_block(state, key):
    """ConvBNBlock (tacotron2.py:11): conv + folded eval-mode BatchNorm."""
    return {
        "conv": _conv(state, f"{key}.convolution1d"),
        **_fold_bn_scale_shift(state, f"{key}.batch_normalization"),
    }


def _fold_bn_scale_shift(state, key, eps=1e-5):
    f = _fold_bn(state, key, eps)
    return {"scale": f["scale"], "shift": f["shift"]}


def convert_tacotron2(state, num_chars=None, r=2):
    """Full Tacotron2 → flax params (use ``norm_type="folded"``).

    BiLSTM directions map to the fwd/bwd ``nn.RNN`` pair; attention/decoder
    LSTMCells and the location layer convert via the generic rules."""
    state = dict(state)
    enc = {
        f"conv_{i}": _conv_bn_block(state, f"encoder.convolutions.{i}")
        for i in range(3)
    }
    enc["lstm_fwd"] = _lstm_cell(state, "encoder.lstm", "_l0")
    enc["lstm_bwd"] = _lstm_cell(state, "encoder.lstm", "_l0_reverse")

    cell = {
        "prenet": {
            "linear_0": _dense(state, "decoder.prenet.linear_layers.0.linear_layer"),
            "linear_1": _dense(state, "decoder.prenet.linear_layers.1.linear_layer"),
        },
        "attention_rnn": _lstm_cell(state, "decoder.attention_rnn"),
        "decoder_rnn": _lstm_cell(state, "decoder.decoder_rnn"),
        "linear_projection": _dense(state, "decoder.linear_projection.linear_layer"),
        "stopnet": _dense(state, "decoder.stopnet.1.linear_layer"),
    }
    if "decoder.attention.key_layer.weight" in state:
        # dynamic-convolution attention (tacotron2-DCA zoo entries;
        # reference attentions.py:323 — raw nn.Linear layers, no wrapper)
        cell.update(
            query_layer=_dense(state, "decoder.attention.query_layer"),
            key_layer=_dense(state, "decoder.attention.key_layer"),
            static_filter_conv={
                "kernel": conv1d_kernel(state["decoder.attention.static_filter_conv.weight"])
            },
            static_filter_layer=_dense(state, "decoder.attention.static_filter_layer"),
            dynamic_filter_layer=_dense(state, "decoder.attention.dynamic_filter_layer"),
            v=_dense(state, "decoder.attention.v"),
        )
    else:
        cell.update(
            query_layer=_dense(state, "decoder.attention.query_layer.linear_layer"),
            location_conv={
                "kernel": conv1d_kernel(
                    state["decoder.attention.location_layer.location_conv1d.weight"]
                )
            },
            location_dense=_dense(
                state, "decoder.attention.location_layer.location_dense.linear_layer"
            ),
            v=_dense(state, "decoder.attention.v.linear_layer"),
        )
    post = {
        f"conv_{i}": _conv_bn_block(state, f"postnet.convolutions.{i}")
        for i in range(5)
    }
    if "decoder.attention.inputs_layer.linear_layer.weight" in state:
        inputs_layer = _dense(state, "decoder.attention.inputs_layer.linear_layer")
    else:
        # DCA has no inputs_layer (preprocess_inputs → None, :432); our
        # module still owns the Dense but the DCA branch never reads it
        dec_rnn_dim = state["decoder.decoder_rnn.weight_hh"].shape[1]
        in_dim = state["decoder.linear_projection.linear_layer.weight"].shape[1] - dec_rnn_dim
        inputs_layer = {"kernel": np.zeros((in_dim, 128), np.float32)}
    p = {
        "embedding": {"embedding": state["embedding.weight"]},
        "encoder": enc,
        "decoder_cell": cell,
        "inputs_layer": inputs_layer,
        "postnet": post,
    }
    if "speaker_embedding.weight" in state:
        p["speaker_embedding"] = {"embedding": state["speaker_embedding.weight"]}
    if any(k.startswith("gst_layer.") for k in state):
        p["gst_layer"] = convert_gst(state, "gst_layer.")
    if any(k.startswith("capacitron_vae_layer.") for k in state):
        p["capacitron_vae_layer"] = convert_capacitron(state, "capacitron_vae_layer.")
    return {"params": p}


def _ref_encoder_convs(s, prefix):
    """Shared conv-stack mapping for both reference encoders: Conv2d +
    eval-mode BatchNorm2d folded to the flax ``folded`` affine."""
    p = {}
    for i in range(6):
        p[f"conv_{i}"] = {
            "kernel": conv2d_kernel(s[f"{prefix}convs.{i}.weight"]),
            "bias": s[f"{prefix}convs.{i}.bias"],
        }
        f = _fold_bn(s, f"{prefix}bns.{i}")
        p[f"scale_{i}"], p[f"shift_{i}"] = f["scale"], f["shift"]
    return p


def convert_gst(state, prefix="gst_layer."):
    """Reference ``GST`` (gst_layers.py:6) → flax ``layers.tacotron_v1.GST``
    params (use ``norm_type="folded"`` on the flax module)."""
    s = _subdict(state, prefix)
    enc = _ref_encoder_convs(s, "encoder.")
    enc["gru"] = _gru_cell(s, "encoder.recurrence")
    stl = {
        "style_tokens": s["style_token_layer.style_tokens"],
        "W_query": _dense(s, "style_token_layer.attention.W_query"),
        "W_key": _dense(s, "style_token_layer.attention.W_key"),
        "W_value": _dense(s, "style_token_layer.attention.W_value"),
    }
    return {"encoder": enc, "style_token_layer": stl}


def convert_capacitron(state, prefix="capacitron_vae_layer."):
    """Reference ``CapacitronVAE`` (capacitron_layers.py:11) → flax
    ``layers.capacitron.CapacitronVAE`` params (``norm_type="folded"``)."""
    s = _subdict(state, prefix)
    ref = _ref_encoder_convs(s, "encoder.")
    ref["lstm"] = _lstm_cell(s, "encoder.recurrence", "_l0")
    p = {
        "ref_encoder": ref,
        "post_mlp": {
            "hidden": _dense(s, "post_encoder_mlp.net.0"),
            "out": _dense(s, "post_encoder_mlp.net.2"),
        },
        "beta": np.asarray(s["beta"]).reshape(()),
    }
    if "text_summary_net.lstm.weight_ih_l0" in s:
        p["text_summary"] = {"lstm": _lstm_cell(s, "text_summary_net.lstm", "_l0")}
    return p


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
    state_dict of ``VitsModule``; ``args`` is the model's ``VitsArgs``. A
    YourTTS checkpoint's ``speaker_encoder.*`` (the encoder its training
    loss used) is dropped, as ``tts_tpu/utils/zoo_convert.py:35`` drops it."""
    state = {k: _to_numpy(v) for k, v in state.items() if not k.startswith("speaker_encoder.")}
    return vits_from_jax_params(convert_vits_generator(state, args))


def load_reference_glow_tts(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout GlowTTS state dict (tensors or arrays) → the
    state_dict of ``GlowTTSModule``; ``config`` is the model's
    ``GlowTTSConfig``."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    return glow_tts_from_jax_params(convert_glow_tts(state, config))


def load_reference_tacotron2(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout Tacotron2 state dict (tensors or arrays) → the
    state_dict of ``Tacotron2Module`` with folded norms; sets
    ``config.norm_type = "folded"``, as the JAX package's zoo conversion
    does (``tts_tpu/utils/zoo_convert.py:45-49``). A DCA checkpoint has no
    ``inputs_layer``: the module's, which DCA never reads, is zeros of the
    config's ``attn_dim``."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    config.norm_type = "folded"
    out = tacotron2_from_jax_params(convert_tacotron2(state))
    if "decoder.attention.inputs_layer.linear_layer.weight" not in state:
        out["inputs_layer.weight"] = torch.zeros(config.attn_dim,
                                                 out["inputs_layer.weight"].shape[1])
    return out


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
    ``tts_tpu/utils/zoo_convert.py:68-126``: HiFiGAN, the MelGANs,
    ParallelWaveGAN, UnivNet, WaveGrad and WaveRNN, each converter's depth
    read from its config as there)."""
    state = _strip_prefix({k: _to_numpy(v) for k, v in state.items()}, "model_g.")
    name = config.generator_model.lower()
    if name == "hifigan_generator":
        return flax_to_state_dict(convert_hifigan_generator(state))
    gp = getattr(config, "generator_model_params", None) or {}
    if name in ("melgan_generator", "multiband_melgan_generator", "fullband_melgan_generator"):
        return melgan_from_jax_params(convert_melgan_generator(
            state, num_upsample_stages=len(gp["upsample_factors"]),
            num_res_blocks=gp.get("num_res_blocks", 3)))
    if name == "parallel_wavegan_generator":
        return parallel_wavegan_from_jax_params(convert_parallel_wavegan_generator(
            state, num_res_blocks=gp.get("num_res_blocks", 30),
            num_upsample_stages=len(gp.get("upsample_factors", [4, 4, 4, 4]))))
    if name == "univnet_generator":
        gp = gp or getattr(config, "model_params", {}) or {}
        return univnet_from_jax_params(convert_univnet_generator(
            state, num_blocks=len(gp.get("upsample_factors", [8, 8, 4]))))
    if name == "wavegrad":
        return wavegrad_from_jax_params(convert_wavegrad(state))
    if name == "wavernn":
        ma = getattr(config, "model_args", {}) or {}
        return wavernn_from_jax_params(convert_wavernn(
            state, num_res_blocks=ma.get("num_res_blocks", 10),
            num_upsample_stages=len(ma.get("upsample_factors", [4, 8, 8]))))
    raise NotImplementedError(f"no reference-layout converter for the vocoder generator "
                              f"{name!r} (the iSTFT generator has no reference layout)")


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


_TACOTRON2_RULES = (
    (r"^encoder\.conv_(\d+)\.conv\.", r"encoder.convolutions.\1.convolution1d."),
    (r"^encoder\.conv_(\d+)\.(weight|bias)$", r"encoder.convolutions.\1.batch_normalization.\2"),
    (r"^postnet\.conv_(\d+)\.conv\.", r"postnet.convolutions.\1.convolution1d."),
    (r"^postnet\.conv_(\d+)\.(weight|bias)$", r"postnet.convolutions.\1.batch_normalization.\2"),
    (r"^decoder_cell\.prenet\.linear_(\d+)\.", r"decoder.prenet.linear_layers.\1.linear_layer."),
    (r"^decoder_cell\.(attention_rnn|decoder_rnn)\.", r"decoder.\1."),
    (r"^decoder_cell\.linear_projection\.", "decoder.linear_projection.linear_layer."),
    (r"^decoder_cell\.stopnet\.", "decoder.stopnet.1.linear_layer."),
    (r"^inputs_layer\.", "decoder.attention.inputs_layer.linear_layer."),
)
_LOCATION_RULES = (
    (r"^decoder_cell\.(query_layer|v)\.", r"decoder.attention.\1.linear_layer."),
    (r"^decoder_cell\.location_conv\.", "decoder.attention.location_layer.location_conv1d."),
    (r"^decoder_cell\.location_dense\.",
     "decoder.attention.location_layer.location_dense.linear_layer."),
)
_DCA_RULES = ((r"^decoder_cell\.", "decoder.attention."),)
_REF_ENCODERS = r"^(gst_layer\.encoder|capacitron_vae_layer\.ref_encoder)\."
_STYLE_RULES = (
    (_REF_ENCODERS + r"conv_(\d+)\.", r"\1.convs.\2."),
    (_REF_ENCODERS + r"scale_(\d+)$", r"\1.bns.\2.weight"),
    (_REF_ENCODERS + r"shift_(\d+)$", r"\1.bns.\2.bias"),
    (r"^capacitron_vae_layer\.ref_encoder\.", "capacitron_vae_layer.encoder."),
    (r"^(gst_layer|capacitron_vae_layer)\.encoder\.(gru|lstm)\.", r"\1.encoder.recurrence."),
    (r"^gst_layer\.style_token_layer\.W_", "gst_layer.style_token_layer.attention.W_"),
    (r"^capacitron_vae_layer\.text_summary\.", "capacitron_vae_layer.text_summary_net."),
    (r"^capacitron_vae_layer\.post_mlp\.hidden\.",
     "capacitron_vae_layer.post_encoder_mlp.net.0."),
    (r"^capacitron_vae_layer\.post_mlp\.out\.", "capacitron_vae_layer.post_encoder_mlp.net.2."),
)


def reference_tacotron2_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of a ``Tacotron2Module`` with folded norms and
    location-sensitive or DCA attention, with or without GST and Capacitron,
    in the reference's (coqui) names: each folded norm as an eval-mode
    BatchNorm (running mean 0, running variance ``1 - 1e-5``, so that it
    folds back exactly), the DCA without ``inputs_layer``.
    :func:`load_reference_tacotron2` maps it back."""
    dca = "decoder_cell.key_layer.weight" in state
    rules = _TACOTRON2_RULES + (_DCA_RULES if dca else _LOCATION_RULES) + _STYLE_RULES
    out = {}
    for key, value in state.items():
        if dca and key.startswith("inputs_layer."):
            continue
        k = _reference_key(key, rules)
        out[k] = value.detach().cpu().numpy()
        if re.search(r"(batch_normalization|\.bns\.\d+)\.weight$", k):
            base = k[: -len("weight")]
            out[base + "running_mean"] = np.zeros_like(out[k])
            out[base + "running_var"] = np.full_like(out[k], np.float32(1) - np.float32(1e-5))
            out[base + "num_batches_tracked"] = np.zeros((), np.int64)
    unmapped = [k for k in out if k.startswith("decoder_cell.")]
    if unmapped or any(re.search(r"\.norm(_\d+)?\.", k) for k in out):
        raise ValueError(f"no reference layout for {unmapped or 'layer norms'} (folded norms "
                         f"and location or DCA attention only)")
    return out


# ---------------------------------------------------------------------------
# Speaker encoders (copied from ``tts_tpu/utils/convert.py:1496-1512``), unchanged.
# ---------------------------------------------------------------------------


def convert_lstm_speaker_encoder(state, num_layers=3):
    """Reference LSTMSpeakerEncoder (LSTMWithProjection stack) → flax params
    for :class:`tts_tpu.encoder.model.LSTMSpeakerEncoder`."""
    p = {}
    for i in range(num_layers):
        p[f"lstm_{i}"] = _lstm_cell(state, f"layers.{i}.lstm", "_l0")
        p[f"proj_{i}"] = {"kernel": linear_kernel(state[f"layers.{i}.linear.weight"])}
    return {"params": p}


def convert_speaker_encoder(state, config):
    """Dispatch on config.model_params.model_name (lstm | resnet)."""
    mp = dict(getattr(config, "model_params", {}) or {})
    name = mp.get("model_name", "resnet")
    if name == "lstm":
        return convert_lstm_speaker_encoder(state, mp.get("num_lstm_layers", 3))
    return {"params": convert_resnet_speaker_encoder(state)}


def speaker_encoder_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``LSTMSpeakerEncoder`` or ``ResNetSpeakerEncoder``
    (folded norms) params → the state_dict of the port's module: each flax
    LSTM cell packed into ``layers.<i>.lstm``, its projection into
    ``layers.<i>.linear``; the ResNet by the generic rules."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    if "lstm_0" not in params:
        return flax_to_state_dict(params)
    state = {}
    for i in range(len([k for k in params if k.startswith("lstm_")])):
        state.update({f"layers.{i}.lstm.{k}": torch.from_numpy(v)
                      for k, v in _pack_lstm(params[f"lstm_{i}"], "_l0").items()})
        kernel = np.asarray(params[f"proj_{i}"]["kernel"], np.float32)
        state[f"layers.{i}.linear.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
    return state


def load_reference_speaker_encoder(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout speaker encoder state dict (tensors or arrays; a
    ResNet's ``torch_spec`` buffers are not read) → the state_dict of the
    port's module that ``config.model_params`` names."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    return speaker_encoder_from_jax_params(convert_speaker_encoder(state, config))


_RESNET_ENCODER_RULES = (
    (r"\.se\.fc1\.", ".se.fc.0."),
    (r"\.se\.fc2\.", ".se.fc.2."),
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
    (r"^attn_conv1\.", "attention.0."),
    (r"^attn_bn\.", "attention.2."),
    (r"^attn_conv2\.", "attention.3."),
)
_BATCH_NORM = re.compile(r"(^|\.)(bn\d|downsample\.1|attention\.2)\.weight$")


def reference_speaker_encoder_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's speaker encoder in the reference's
    (coqui) names and layouts: the LSTM's as it is; the ResNet's 2-D
    kernels over (mel, time), each folded norm as an eval-mode BatchNorm
    (running mean 0, running variance ``1 - 1e-5``, so that it folds back
    exactly). :func:`load_reference_speaker_encoder` maps it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _RESNET_ENCODER_RULES)
        if v.ndim == 4:
            v = np.ascontiguousarray(v.transpose(0, 1, 3, 2))  # (time, mel) taps → (mel, time)
        out[k] = v
        if _BATCH_NORM.search(k):
            base = k[: -len("weight")]
            out[base + "running_mean"] = np.zeros_like(v)
            out[base + "running_var"] = np.full_like(v, np.float32(1) - np.float32(1e-5))
            out[base + "num_batches_tracked"] = np.zeros((), np.int64)
    return out


# ---------------------------------------------------------------------------
# ForwardTTS (copied from ``tts_tpu/utils/convert.py:1355-1441``), unchanged.
# ---------------------------------------------------------------------------


def _mha(state, prefix, heads):
    """torch nn.MultiheadAttention → flax MultiHeadDotProductAttention."""
    w = state[f"{prefix}.in_proj_weight"]  # [3D, D] rows q,k,v
    b = state[f"{prefix}.in_proj_bias"]
    D = w.shape[1]
    dh = D // heads

    def leaf(wi, bi):
        return {"kernel": wi.T.reshape(D, heads, dh), "bias": bi.reshape(heads, dh)}

    out_w = state[f"{prefix}.out_proj.weight"]  # [D, D]
    return {
        "query": leaf(w[:D], b[:D]),
        "key": leaf(w[D : 2 * D], b[D : 2 * D]),
        "value": leaf(w[2 * D :], b[2 * D :]),
        "out": {"kernel": out_w.T.reshape(heads, dh, D), "bias": state[f"{prefix}.out_proj.bias"]},
    }


def _fft_block(state, prefix, num_layers, heads):
    """Reference FFTransformerBlock ``fft_layers.{i}`` → our ``fft_{i}``."""
    p = {}
    for i in range(num_layers):
        k = f"{prefix}fft_layers.{i}"
        p[f"fft_{i}"] = {
            "self_attn": _mha(state, f"{k}.self_attn", heads),
            "conv1": _conv(state, f"{k}.conv1"),
            "conv2": _conv(state, f"{k}.conv2"),
            "norm1": _layernorm(state, f"{k}.norm1"),
            "norm2": _layernorm(state, f"{k}.norm2"),
        }
    return p


def _variance_predictor(state, prefix):
    """DurationPredictor-style conv/LN/conv/LN/proj stack (forward_tts)."""
    return {
        "conv_1": _conv(state, f"{prefix}conv_1"),
        "norm_1": {"LayerNorm_0": _layernorm(state, f"{prefix}norm_1")},
        "conv_2": _conv(state, f"{prefix}conv_2"),
        "norm_2": {"LayerNorm_0": _layernorm(state, f"{prefix}norm_2")},
        "proj": _plain_conv(state, f"{prefix}proj"),
    }


def convert_forward_tts(state, args):
    """Full reference ForwardTTS state dict → flax params.

    ``args`` is our ForwardTTSArgs (layer counts/heads drive the maps).
    Supports the fftransformer encoder/decoder types (FastPitch/FastSpeech
    family); conv-BN types (speedy_speech) are not yet weight-compatible.
    """
    enc_p = getattr(args, "encoder_params", {}) or {}
    dec_p = getattr(args, "decoder_params", {}) or {}
    enc_layers = enc_p.get("num_layers", 6)
    enc_heads = enc_p.get("num_heads", 1)
    dec_layers = dec_p.get("num_layers", 6)
    dec_heads = dec_p.get("num_heads", 1)

    p = {
        "emb": {"embedding": state["emb.weight"]},
        "encoder": _fft_block(state, "encoder.encoder.", enc_layers, enc_heads),
        "decoder": _fft_block(
            state, "decoder.decoder.transformer_block.", dec_layers, dec_heads
        ),
        "proj": _dense(state, "decoder.decoder.postnet"),
        "duration_predictor": _variance_predictor(state, "duration_predictor."),
    }
    if "pos_encoder.scale" in state:
        p["pos_encoder"] = {"scale": state["pos_encoder.scale"].reshape(-1)}
    if "pitch_predictor.conv_1.weight" in state:
        p["pitch_predictor"] = _variance_predictor(state, "pitch_predictor.")
        p["pitch_emb"] = _conv(state, "pitch_emb")
    if "energy_predictor.conv_1.weight" in state:
        p["energy_predictor"] = _variance_predictor(state, "energy_predictor.")
        p["energy_emb"] = _conv(state, "energy_emb")
    if "aligner.key_layer.0.weight" in state:
        p["aligner"] = {
            "key_conv1": _conv(state, "aligner.key_layer.0"),
            "key_conv2": _conv(state, "aligner.key_layer.2"),
            "query_conv1": _conv(state, "aligner.query_layer.0"),
            "query_conv2": _conv(state, "aligner.query_layer.2"),
            "query_conv3": _conv(state, "aligner.query_layer.4"),
        }
    if "emb_g.weight" in state:
        p["emb_g"] = {"embedding": state["emb_g.weight"]}
    return {"params": p}


def _pack_attention(attn: Mapping) -> Dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` Denses → ``in_proj_weight``
    ``[3C, C]`` (rows q, k, v), ``in_proj_bias`` and ``out_proj``."""
    def rows(name):
        kernel = np.asarray(attn[name]["kernel"], np.float32)  # [C, H, dh]
        return kernel.reshape(kernel.shape[0], -1).T, np.asarray(attn[name]["bias"],
                                                                 np.float32).reshape(-1)

    (wq, bq), (wk, bk), (wv, bv) = rows("query"), rows("key"), rows("value")
    out = np.asarray(attn["out"]["kernel"], np.float32)  # [H, dh, C]
    return {"in_proj_weight": np.concatenate([wq, wk, wv]),
            "in_proj_bias": np.concatenate([bq, bk, bv]),
            "out_proj.weight": out.reshape(-1, out.shape[-1]).T,
            "out_proj.bias": np.asarray(attn["out"]["bias"], np.float32)}


def _carry_attention(params: Mapping, drop: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """The generic rules, with each flax ``self_attn`` packed
    (:func:`_pack_attention`); subtrees named in ``drop`` are left out."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    attns: Dict[str, np.ndarray] = {}

    def split(tree: Mapping, path: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for key, value in tree.items():
            if key in drop:
                continue
            if key == "self_attn":
                attns.update({".".join(path + (key, leaf)): w
                              for leaf, w in _pack_attention(value).items()})
            else:
                out[key] = split(value, path + (key,)) if isinstance(value, Mapping) else value
        return out

    state = flax_to_state_dict(split(params, ()))
    state.update({k: torch.from_numpy(np.array(v, order="C")) for k, v in attns.items()})
    return state


def forward_tts_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ForwardTTSModule`` params (or those of one of its
    blocks) → the state_dict of the port's module: the generic rules, each
    ``self_attn`` packed (:func:`_pack_attention`); the ``aligner``, which
    only training runs, is dropped."""
    return _carry_attention(params, drop=("aligner",))


def align_tts_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``AlignTTSModule`` params → the state_dict of the
    port's module, as :func:`forward_tts_from_jax_params` carries
    ForwardTTS's; the MDN head (``mdn_conv1``, ``mdn_norm``, ``mdn_conv2``),
    which only training runs, is dropped."""
    return _carry_attention(params, drop=("mdn_conv1", "mdn_norm", "mdn_conv2"))


def load_reference_forward_tts(state: Mapping, args) -> Dict[str, torch.Tensor]:
    """A reference-layout ForwardTTS state dict (tensors or arrays) → the
    state_dict of ``ForwardTTSModule``; ``args`` is the model's
    ``ForwardTTSArgs``. The aligner and the positional table are not kept.
    FFTransformer encoders and decoders only: the JAX package maps no
    SpeedySpeech checkpoint (its conv blocks have LayerNorm where the
    reference's have BatchNorm), so neither does the port."""
    if args.encoder_type != "fftransformer" or args.decoder_type != "fftransformer":
        raise NotImplementedError("no reference-layout converter for the residual_conv_bn "
                                  "blocks of SpeedySpeech (ROADMAP.md item 16)")
    state = {k: _to_numpy(v) for k, v in state.items()}
    return forward_tts_from_jax_params(convert_forward_tts(state, args))


_FORWARD_TTS_RULES = (
    (r"^encoder\.fft_(\d+)\.", r"encoder.encoder.fft_layers.\1."),
    (r"^decoder\.fft_(\d+)\.", r"decoder.decoder.transformer_block.fft_layers.\1."),
    (r"^proj\.", "decoder.decoder.postnet."),
    (r"^pos_encoder\.weight$", "pos_encoder.scale"),
)


def reference_forward_tts_state(state: Mapping[str, torch.Tensor],
                                pe: torch.Tensor = None) -> Dict[str, np.ndarray]:
    """The state_dict of a ``ForwardTTSModule`` with FFTransformer blocks in
    the reference's (coqui) names and layouts: ``gamma``/``beta``
    ``[1, C, 1]`` for the predictors' norms, a 1x1 convolution for the
    output projection, and the
    positional table ``pe`` (``[max_len, C]``) as the reference's buffer
    ``[1, C, max_len]`` when given. :func:`load_reference_forward_tts` maps
    it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _FORWARD_TTS_RULES)
        if re.search(r"predictor\.norm_[12]\.(weight|bias)$", k):
            k = k[: -len("weight")] + "gamma" if k.endswith("weight") else k[: -len("bias")] + "beta"
            v = v[None, :, None]
        if k == "decoder.decoder.postnet.weight":
            v = v[:, :, None]
        out[k] = v
    if any(".block" in k for k in out):
        raise ValueError("no reference layout for residual_conv_bn blocks (FFTransformer only)")
    if pe is not None:
        out["pos_encoder.pe"] = pe.detach().cpu().numpy().T[None]
    return out


# ---------------------------------------------------------------------------
# Overflow / NeuralHMM (copied from ``tts_tpu/utils/convert.py:1448-1488``),
# unchanged.
# ---------------------------------------------------------------------------

def convert_overflow(state, config):
    """Reference Overflow/NeuralhmmTTS state dict → flax params
    (use with ``config.norm_type='folded'``)."""
    state = dict(state)
    enc = {
        "emb": {"embedding": state["encoder.emb.weight"]},
        "lstm_fwd": _lstm_cell(state, "encoder.lstm", "_l0"),
        "lstm_bwd": _lstm_cell(state, "encoder.lstm", "_l0_reverse"),
    }
    for i in range(getattr(config, "encoder_n_convolutions", 3)):
        enc[f"conv_{i}"] = _conv_bn_block(state, f"encoder.convolutions.{i}")

    n_layers = len(getattr(config, "outputnet_size", [1024, 1024]))
    out_net = {
        "proj": _dense(state, "neural_hmm.output_net.parametermodel.last_layer"),
    }
    for i in range(n_layers):
        out_net[f"layer_{i}"] = _dense(
            state, f"neural_hmm.output_net.parametermodel.layers.{i}.linear_layer"
        )
    prenet = {}
    for i in range(getattr(config, "prenet_n_layers", 1)):
        w = state[f"neural_hmm.prenet.linear_layers.{i}.linear_layer.weight"]
        prenet[f"linear_{i}"] = {
            "kernel": linear_kernel(w),
            "bias": np.zeros((w.shape[0],), w.dtype),  # reference prenet is bias-free
        }
    p = {
        "encoder": enc,
        "neural_hmm": {
            "prenet": prenet,
            "memory_rnn": _lstm_cell(state, "neural_hmm.memory_rnn", ""),
            "output_net": out_net,
        },
    }
    if "decoder.glow_decoder.flows.0.logs" in state:
        p["decoder"] = convert_glow_decoder(
            state, "decoder.glow_decoder.",
            getattr(config, "num_flow_blocks_dec", 12),
            getattr(config, "num_block_layers", 4),
        )
    return {"params": p}


def load_reference_overflow(state: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference-layout Overflow or NeuralHMM state dict (tensors or
    arrays) → the state_dict of ``NeuralhmmTTSModule`` with folded norms, as
    ``tts_tpu/utils/zoo_convert.py:58-65`` converts it: sets
    ``config.norm_type = "folded"`` and, where the checkpoint has its
    ``mean``/``std`` buffers, ``config.mel_statistics_mean/std``."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    config.norm_type = "folded"
    if "mean" in state:
        config.mel_statistics_mean = float(state["mean"])
        config.mel_statistics_std = float(state["std"])
    return overflow_from_jax_params(convert_overflow(state, config))


_OVERFLOW_RULES = (
    (r"^encoder\.conv_(\d+)\.conv\.", r"encoder.convolutions.\1.convolution1d."),
    (r"^encoder\.conv_(\d+)\.(weight|bias)$", r"encoder.convolutions.\1.batch_normalization.\2"),
    (r"^neural_hmm\.prenet\.linear_(\d+)\.", r"neural_hmm.prenet.linear_layers.\1.linear_layer."),
    (r"^neural_hmm\.output_net\.layer_(\d+)\.",
     r"neural_hmm.output_net.parametermodel.layers.\1.linear_layer."),
    (r"^neural_hmm\.output_net\.proj\.", "neural_hmm.output_net.parametermodel.last_layer."),
)


def reference_overflow_state(state: Mapping[str, torch.Tensor], mean: float = 0.0,
                             std: float = 1.0) -> Dict[str, np.ndarray]:
    """The state_dict of a ``NeuralhmmTTSModule`` with folded norms in the
    reference's (coqui) names and layouts, with the mel statistics as its
    ``mean``/``std`` buffers: each folded norm as an eval-mode BatchNorm
    (running mean 0, running variance ``1 - 1e-5``, so that it folds back
    exactly), the prenet without its bias (which must be zero: the
    reference's prenet has none), the post-flow as GlowTTS's decoder under
    ``decoder.glow_decoder.``. :func:`load_reference_overflow` maps it
    back."""
    flows = reference_glow_tts_state({k: v for k, v in state.items()
                                      if k.startswith("decoder.")})
    out = {k.replace("decoder.", "decoder.glow_decoder.", 1): v for k, v in flows.items()}
    for key, value in state.items():
        if key.startswith("decoder."):
            continue
        v = value.detach().cpu().numpy()
        if re.fullmatch(r"neural_hmm\.prenet\.linear_\d+\.bias", key):
            if np.any(v != 0):
                raise ValueError(f"{key} is not zero: the reference's prenet has no bias")
            continue
        k = _reference_key(key, _OVERFLOW_RULES)
        out[k] = v
        if k.endswith("batch_normalization.weight"):
            base = k[: -len("weight")]
            out[base + "running_mean"] = np.zeros_like(v)
            out[base + "running_var"] = np.full_like(v, np.float32(1) - np.float32(1e-5))
            out[base + "num_batches_tracked"] = np.zeros((), np.int64)
    if any(".norm." in k for k in out):
        raise ValueError("no reference layout for layer norms (folded norms only)")
    out["mean"] = np.asarray(mean, np.float32)
    out["std"] = np.asarray(std, np.float32)
    return out


_DELIGHTFUL_TRAINING = ("aligner", "utterance_prosody_encoder", "phoneme_prosody_encoder")


def delightful_tts_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's DelightfulTTS params (``{"acoustic": ...,
    "vocoder": ...}``, each a flax tree) → the state_dict of
    ``DelightfulTTSModule``: the acoustic tree under ``acoustic_model.``
    and the joint HiFiGAN's under ``vocoder.``, by the generic rules. The
    subtrees only training runs (the aligner and the two prosody encoders
    that read mels) are dropped, as :func:`forward_tts_from_jax_params`
    drops the ForwardTTS aligner; the discriminator, which the JAX package
    keeps apart, is not there."""
    acoustic = params["acoustic"]
    if "params" in acoustic and len(acoustic) == 1:
        acoustic = acoustic["params"]
    state = flax_to_state_dict({k: v for k, v in acoustic.items()
                                if k not in _DELIGHTFUL_TRAINING}, "acoustic_model.")
    state.update(flax_to_state_dict(params["vocoder"], "vocoder."))
    return state


# ---------------------------------------------------------------------------
# ParallelWaveGAN, UnivNet, WaveGrad and WaveRNN (copied from
# ``tts_tpu/utils/convert.py:809-873`` and ``:1258-1354``), unchanged apart
# from UnivNet's LVC layers, all of which are read (F34).
# ---------------------------------------------------------------------------


def _shared_tap(w):
    """Reference Conv2d(1, 1, (1, k)) smoothing weight [1,1,1,k] → (k,1,1)."""
    return np.asarray(w).reshape(-1)[:, None, None]


def convert_parallel_wavegan_generator(state, num_res_blocks=30, num_upsample_stages=4):
    state = fold_weight_norm(state)
    p = {
        "first_conv": _dense(state, "first_conv"),
        "last_conv_1": _dense(state, "last_conv_layers.1"),
        "last_conv_2": _dense(state, "last_conv_layers.3"),
        "upsample_net": {
            "conv_in": _plain_conv(state, "upsample_net.conv_in"),
        },
    }
    for i in range(num_upsample_stages):
        p["upsample_net"][f"up_{i}"] = _shared_tap(
            state[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"]
        )
    for i in range(num_res_blocks):
        k = f"conv_layers.{i}"
        p[f"res_{i}"] = {
            "conv": _plain_conv(state, f"{k}.conv"),
            "conv1x1_aux": _dense(state, f"{k}.conv1x1_aux"),
            "conv1x1_out": _dense(state, f"{k}.conv1x1_out"),
            "conv1x1_skip": _dense(state, f"{k}.conv1x1_skip"),
        }
    return {"params": p}


def convert_univnet_generator(state, num_blocks=3, kpnet_res_blocks=3):
    """Reference UnivNet → flax-layout params. Every ``convs.<j>`` of an LVC
    block is read, where the JAX package's copy reads ``convs.0`` and
    ``convs.1`` only, though its generator and ``UnivnetConfig`` build 4
    layers a block (ROADMAP.md F34)."""
    state = fold_weight_norm(state)
    p = {
        "first_conv": _plain_conv(state, "first_conv"),
        "last_conv": _plain_conv(state, "last_conv_layers.0"),
    }
    for i in range(num_blocks):
        k = f"lvc_blocks.{i}"
        layers = 0
        while f"{k}.convs.{layers}.weight" in state:
            layers += 1
        blk = {
            **{f"conv_{j}": _plain_conv(state, f"{k}.convs.{j}") for j in range(layers)},
            "upsample": _convtranspose(state, f"{k}.upsample"),
            "kernel_predictor": {
                "input_conv": _plain_conv(state, f"{k}.kernel_predictor.input_conv.0"),
                "kernel_conv": _plain_conv(state, f"{k}.kernel_predictor.kernel_conv"),
                "bias_conv": _plain_conv(state, f"{k}.kernel_predictor.bias_conv"),
            },
        }
        for r in range(kpnet_res_blocks):
            blk["kernel_predictor"][f"res_{r}a"] = _plain_conv(
                state, f"{k}.kernel_predictor.residual_conv.{5 * r + 1}"
            )
            blk["kernel_predictor"][f"res_{r}b"] = _plain_conv(
                state, f"{k}.kernel_predictor.residual_conv.{5 * r + 3}"
            )
        p[f"lvc_{i}"] = blk
    return {"params": p}


def convert_wavegrad(state, num_dblocks=4, num_ublocks=5):
    state = fold_weight_norm(state)
    p = {
        "y_conv": _plain_conv(state, "y_conv"),
        "x_conv": _plain_conv(state, "x_conv"),
        "out_conv": _plain_conv(state, "out_conv"),
    }
    for i in range(num_dblocks):
        k = f"dblocks.{i}"
        if f"{k}.res_block.weight" not in state:
            break
        p[f"dblock_{i}"] = {
            "res_block": _dense(state, f"{k}.res_block"),
            **{f"main_{j}": _plain_conv(state, f"{k}.main_block.{j}") for j in range(3)},
        }
    i = 0
    while f"film.{i}.input_conv.weight" in state:
        p[f"film_{i}"] = {
            "input_conv": _plain_conv(state, f"film.{i}.input_conv"),
            "output_conv": _plain_conv(state, f"film.{i}.output_conv"),
        }
        i += 1
    for i in range(num_ublocks):
        k = f"ublocks.{i}"
        if f"{k}.res_block.weight" not in state:
            break
        p[f"ublock_{i}"] = {
            "res_block": _dense(state, f"{k}.res_block"),
            **{f"main_{j}": _plain_conv(state, f"{k}.main_block.{j}") for j in range(2)},
            **{f"out_{j}": _plain_conv(state, f"{k}.out_block.{j}") for j in range(2)},
        }
    return {"params": p}


def _gru_cell(state, prefix):
    """torch GRU gates [r,z,n] → flax GRUCell ir/iz/in (biased) + hr/hz
    (bias-free) + hn (biased): r/z hidden biases fold into the input side;
    the n-gate hidden bias stays separate (it is scaled by r)."""
    wi, wh = state[f"{prefix}.weight_ih_l0"], state[f"{prefix}.weight_hh_l0"]
    bi, bh = state[f"{prefix}.bias_ih_l0"], state[f"{prefix}.bias_hh_l0"]
    H = wh.shape[1]
    p = {}
    for gidx, g in enumerate(("r", "z", "n")):
        sl = slice(gidx * H, (gidx + 1) * H)
        p[f"i{g}"] = {"kernel": linear_kernel(wi[sl]), "bias": bi[sl] + (bh[sl] if g != "n" else 0)}
        hk = {"kernel": linear_kernel(wh[sl])}
        if g == "n":
            hk["bias"] = bh[sl]
        p[f"h{g}"] = hk
    return p


def convert_wavernn(state, num_res_blocks=10, num_upsample_stages=3):
    """Full reference Wavernn → flax params (use ``norm_type="folded"``)."""
    state = fold_weight_norm(state)
    resnet = {
        "conv_in": {"kernel": conv1d_kernel(state["upsample.resnet.conv_in.weight"])},
        "conv_out": _plain_conv(state, "upsample.resnet.conv_out"),
    }
    bn = _fold_bn(state, "upsample.resnet.batch_norm")
    resnet["norm_in_scale"], resnet["norm_in_shift"] = bn["scale"], bn["shift"]
    for i in range(num_res_blocks):
        k = f"upsample.resnet.layers.{i}"
        if f"{k}.conv1.weight" not in state:
            break
        resnet[f"res{i}_conv1"] = {"kernel": conv1d_kernel(state[f"{k}.conv1.weight"])}
        resnet[f"res{i}_conv2"] = {"kernel": conv1d_kernel(state[f"{k}.conv2.weight"])}
        b1 = _fold_bn(state, f"{k}.batch_norm1")
        b2 = _fold_bn(state, f"{k}.batch_norm2")
        resnet[f"res{i}_norm1_scale"], resnet[f"res{i}_norm1_shift"] = b1["scale"], b1["shift"]
        resnet[f"res{i}_norm2_scale"], resnet[f"res{i}_norm2_shift"] = b2["scale"], b2["shift"]
    upsample = {"resnet": resnet}
    for i in range(num_upsample_stages):
        key = f"upsample.up_layers.{2 * i + 1}.weight"
        if key not in state:
            break
        upsample[f"up_{i}"] = _shared_tap(state[key])
    p = {
        "upsample": upsample,
        "I": _dense(state, "I"),
        "rnn1": _gru_cell(state, "rnn1"),
        "rnn2": _gru_cell(state, "rnn2"),
        "fc1": _dense(state, "fc1"),
        "fc2": _dense(state, "fc2"),
        "fc3": _dense(state, "fc3"),
    }
    return {"params": p}


def parallel_wavegan_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ParallelWaveganGenerator`` params → the state_dict
    of the port's (``vocoder/models/parallel_wavegan_generator.py``): the
    generic rules; the smoothing taps keep their ``(2f + 1, 1, 1)`` shape."""
    return flax_to_state_dict(params)


def univnet_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``UnivnetGenerator`` params → the state_dict of the
    port's (``vocoder/models/univnet_generator.py``): the generic rules, each
    LVC block's ``upsample`` flipped back into a ``ConvTranspose1d``."""
    return flax_to_state_dict(params)


def wavegrad_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Wavegrad`` params → the state_dict of the port's
    (``vocoder/models/wavegrad.py``), by the generic rules."""
    return flax_to_state_dict(params)


def _pack_gru(cell: Mapping, suffix: str = "") -> Dict[str, np.ndarray]:
    """flax ``GRUCell`` (Denses ``ir``, ``iz``, ``in`` with biases; ``hr``,
    ``hz`` without; ``hn`` with) → ``nn.GRUCell``'s (or, with ``suffix``,
    ``nn.GRU``'s) ``[r; z; n]`` packing: ``bias_ih`` carries the input
    biases, ``bias_hh`` zeros for ``r`` and ``z`` and ``hn``'s bias, which
    both packages scale by ``r``."""
    kernel = lambda name: np.asarray(cell[name]["kernel"], np.float32).T  # noqa: E731
    hn = np.asarray(cell["hn"]["bias"], np.float32)
    return {
        f"weight_ih{suffix}": np.concatenate([kernel(f"i{g}") for g in "rzn"]),
        f"weight_hh{suffix}": np.concatenate([kernel(f"h{g}") for g in "rzn"]),
        f"bias_ih{suffix}": np.concatenate([np.asarray(cell[f"i{g}"]["bias"], np.float32)
                                            for g in "rzn"]),
        f"bias_hh{suffix}": np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn]),
    }


def wavernn_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Wavernn`` params → the state_dict of the port's
    (``vocoder/models/wavernn.py``): the generic rules, and each flax
    ``GRUCell`` packed into an ``nn.GRUCell`` (:func:`_pack_gru`)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    state = flax_to_state_dict({k: v for k, v in params.items() if k not in ("rnn1", "rnn2")})
    for name in ("rnn1", "rnn2"):
        state.update({f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in _pack_gru(params[name]).items()})
    return state


def vocoder_discriminator_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX vocoder discriminator's params → the state_dict of the port's
    (``vocoder/models/``): ``HifiganDiscriminator`` (``mpd``/``msd``,
    ``disc_p<p>``/``disc_s<i>``, ``convs_<i>``), ``MelganDiscriminator`` and
    ``MelganMultiscaleDiscriminator`` (``disc_<i>``, ``conv_down_<i>``),
    ``UnivnetDiscriminator`` (``mrsd``, ``spec_<i>``, 2-D kernels ``[kh, kw,
    in, out]`` → ``[out, in, kh, kw]``), ``ParallelWaveganDiscriminator``
    and ``RandomWindowDiscriminator``: the generic rules, every module named
    as in flax."""
    return flax_to_state_dict(params)


def vocoder_generator_from_jax_params(params: Mapping, generator_model: str
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX vocoder generator's params → the port's state_dict, by the
    carrier of ``generator_model`` (WaveRNN's packs its GRU cells; every
    other generator takes the generic rules)."""
    if generator_model.lower() == "wavernn":
        return wavernn_from_jax_params(params)
    return flax_to_state_dict(params)


def vocoder_train_state_from_jax_params(params: Mapping, generator_model: str
                                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX vocoder train state's params (``{"gen", "disc"}`` of the GAN
    step, or ``{"model"}`` of the generic step) → ``{"model": generator
    state_dict}`` plus ``{"discriminator": ...}`` for a GAN: the groups of
    the port's trainer checkpoints (``utils/io.py``), which
    ``Trainer(--restore_path)`` and the ``Synthesizer``'s vocoder load."""
    gen = params["gen"] if "gen" in params else params["model"]
    out = {"model": vocoder_generator_from_jax_params(gen, generator_model)}
    if "disc" in params:
        out["discriminator"] = vocoder_discriminator_from_jax_params(params["disc"])
    return out


def _with_conv_axis(key: str, v: np.ndarray) -> np.ndarray:
    """A ``Linear`` weight ``[out, in]`` as the reference's 1x1 ``Conv1d``
    ``[out, in, 1]``; anything else unchanged."""
    return v[:, :, None] if key.endswith("weight") and v.ndim == 2 else v


_PWGAN_RULES = (
    (r"^upsample_net\.up_(\d+)$",
     lambda m: f"upsample_net.upsample.up_layers.{2 * int(m.group(1)) + 1}.weight"),
    (r"^res_(\d+)\.", r"conv_layers.\1."),
    (r"^last_conv_1\.", "last_conv_layers.1."),
    (r"^last_conv_2\.", "last_conv_layers.3."),
)


def reference_parallel_wavegan_state(state: Mapping[str, torch.Tensor],
                                     prefix: str = "model_g.") -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``ParallelWaveganGenerator`` in the
    reference's names and layouts (1x1 ``Conv1d`` weights, each smoothing
    tap a ``Conv2d(1, 1, (1, k))`` of ``up_layers``), under ``prefix`` as a
    GAN checkpoint holds its generator. :func:`load_reference_vocoder` maps
    it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _PWGAN_RULES)
        out[prefix + k] = v.reshape(1, 1, 1, -1) if ".up_layers." in k else \
            _with_conv_axis(k, v)
    return out


_UNIVNET_RULES = (
    (r"^lvc_(\d+)\.", r"lvc_blocks.\1."),
    (r"\.conv_(\d+)\.", r".convs.\1."),
    (r"\.kernel_predictor\.input_conv\.", ".kernel_predictor.input_conv.0."),
    (r"\.kernel_predictor\.res_(\d+)([ab])\.",
     lambda m: f".kernel_predictor.residual_conv.{5 * int(m.group(1)) + (1 if m.group(2) == 'a' else 3)}."),
    (r"^last_conv\.", "last_conv_layers.0."),
)


def reference_univnet_state(state: Mapping[str, torch.Tensor],
                            prefix: str = "model_g.") -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``UnivnetGenerator`` in the reference's
    names (``lvc_blocks``, the kernel predictor's ``residual_conv``
    ``Sequential``), under ``prefix``. :func:`load_reference_vocoder` maps it
    back."""
    return {prefix + _reference_key(k, _UNIVNET_RULES): v.detach().cpu().numpy()
            for k, v in state.items()}


_WAVEGRAD_RULES = (
    (r"^film_(\d+)\.", r"film.\1."),
    (r"^dblock_(\d+)\.main_(\d+)\.", r"dblocks.\1.main_block.\2."),
    (r"^dblock_(\d+)\.", r"dblocks.\1."),
    (r"^ublock_(\d+)\.main_(\d+)\.", r"ublocks.\1.main_block.\2."),
    (r"^ublock_(\d+)\.out_(\d+)\.", r"ublocks.\1.out_block.\2."),
    (r"^ublock_(\d+)\.", r"ublocks.\1."),
)


def reference_wavegrad_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``Wavegrad`` in the reference's names
    (``film``, ``dblocks``, ``ublocks`` with their ``main_block`` and
    ``out_block`` lists, 1x1 ``Conv1d`` residual projections), bare as a
    WaveGrad checkpoint holds it. :func:`load_reference_vocoder` maps it
    back."""
    return {(k := _reference_key(key, _WAVEGRAD_RULES)): _with_conv_axis(
        k, v.detach().cpu().numpy()) for key, v in state.items()}


_WAVERNN_RULES = (
    (r"\.norm_in_(scale|shift)$", r".batch_norm.\1"),
    (r"\.res(\d+)_conv([12])\.", r".layers.\1.conv\2."),
    (r"\.res(\d+)_norm([12])_(scale|shift)$", r".layers.\1.batch_norm\2.\3"),
    (r"^upsample\.up_(\d+)$", lambda m: f"upsample.up_layers.{2 * int(m.group(1)) + 1}.weight"),
    (r"^(rnn[12])\.(weight|bias)_(ih|hh)$", r"\1.\2_\3_l0"),
)


def reference_wavernn_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``Wavernn`` with folded norms in the
    reference's names and layouts: each folded norm an eval-mode BatchNorm
    (running mean 0, running variance ``1 - 1e-5``, so that it folds back
    exactly), the GRUs as one-layer ``nn.GRU``, the smoothing taps as
    ``Conv2d(1, 1, (1, k))``. :func:`load_reference_vocoder` maps it back."""
    if any(re.search(r"norm(_in|\d)\.(weight|bias)$", k) for k in state):
        raise ValueError("no reference layout for WaveRNN's layer norms (folded norms only)")
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _WAVERNN_RULES)
        if ".up_layers." in k:
            v = v.reshape(1, 1, 1, -1)
        elif k.endswith(".scale"):
            base = k[: -len("scale")]
            out[base + "running_mean"] = np.zeros_like(v)
            out[base + "running_var"] = np.full_like(v, np.float32(1) - np.float32(1e-5))
            out[base + "num_batches_tracked"] = np.zeros((), np.int64)
            k = base + "weight"
        elif k.endswith(".shift"):
            k = k[: -len("shift")] + "bias"
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# WavLM (copied from ``tts_tpu/utils/convert.py:1519-1628``) and FreeVC
# (``:912-955``), unchanged.
# ---------------------------------------------------------------------------


def _wavlm_fold_pos_conv(state, key="encoder.pos_conv.0."):
    """Fold the pos-conv weight norm (dim=2: g is [1, 1, k], norm over the
    (out, in) axes per kernel tap — the generic fold assumes dim=0)."""
    for g_key, v_key in (
        (key + "weight_g", key + "weight_v"),
        (key + "parametrizations.weight.original0", key + "parametrizations.weight.original1"),
    ):
        if v_key in state:
            g, v = state[g_key], state[v_key]
            axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
            norm = np.sqrt((v**2).sum(axis=axes, keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return state[key + "weight"]


def convert_wavlm_state(state, cfg) -> Dict[str, Any]:
    """Torch WavLM state dict → flax params for
    :class:`tts_tpu.vc.modules.wavlm.WavLM`."""
    p: Dict[str, Any] = {}

    fe: Dict[str, Any] = {}
    for i in range(len(cfg.conv_feature_layers)):
        conv = {"kernel": conv1d_kernel(state[f"feature_extractor.conv_layers.{i}.0.weight"])}
        if cfg.conv_bias:
            conv["bias"] = state[f"feature_extractor.conv_layers.{i}.0.bias"]
        fe[f"conv_{i}"] = conv
        if cfg.extractor_mode == "layer_norm":
            fe[f"ln_{i}"] = {
                "scale": state[f"feature_extractor.conv_layers.{i}.2.1.weight"],
                "bias": state[f"feature_extractor.conv_layers.{i}.2.1.bias"],
            }
        elif i == 0:
            fe["gn_0"] = {
                "scale": state["feature_extractor.conv_layers.0.2.weight"],
                "bias": state["feature_extractor.conv_layers.0.2.bias"],
            }
    p["feature_extractor"] = fe
    p["layer_norm"] = {"scale": state["layer_norm.weight"], "bias": state["layer_norm.bias"]}
    if "post_extract_proj.weight" in state:
        p["post_extract_proj"] = {
            "kernel": linear_kernel(state["post_extract_proj.weight"]),
            "bias": state["post_extract_proj.bias"],
        }

    # grouped positional conv: torch [out, in/groups, k] → flax [k, in/groups, out]
    w = _wavlm_fold_pos_conv(state)
    p["pos_conv"] = {
        "kernel": np.transpose(w, (2, 1, 0)),
        "bias": state["encoder.pos_conv.0.bias"],
    }

    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}."
        attn: Dict[str, Any] = {}
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            attn[proj] = {
                "kernel": linear_kernel(state[pre + f"self_attn.{proj}.weight"]),
                "bias": state[pre + f"self_attn.{proj}.bias"],
            }
        if cfg.gru_rel_pos:
            attn["grep_linear"] = {
                "kernel": linear_kernel(state[pre + "self_attn.grep_linear.weight"]),
                "bias": state[pre + "self_attn.grep_linear.bias"],
            }
            attn["grep_a"] = state[pre + "self_attn.grep_a"]
        if cfg.relative_position_embedding and i == 0:
            attn["relative_attention_bias"] = state[pre + "self_attn.relative_attention_bias.weight"]
        layer = {
            "self_attn": attn,
            "self_attn_layer_norm": {
                "scale": state[pre + "self_attn_layer_norm.weight"],
                "bias": state[pre + "self_attn_layer_norm.bias"],
            },
            "fc1": {"kernel": linear_kernel(state[pre + "fc1.weight"]), "bias": state[pre + "fc1.bias"]},
            "fc2": {"kernel": linear_kernel(state[pre + "fc2.weight"]), "bias": state[pre + "fc2.bias"]},
            "final_layer_norm": {
                "scale": state[pre + "final_layer_norm.weight"],
                "bias": state[pre + "final_layer_norm.bias"],
            },
        }
        p[f"layer_{i}"] = layer
    p["encoder_layer_norm"] = {
        "scale": state["encoder.layer_norm.weight"],
        "bias": state["encoder.layer_norm.bias"],
    }
    return {"params": p}


def convert_freevc(state, config=None):
    """Reference FreeVC checkpoint → flax params for
    :class:`tts_tpu.vc.models.freevc.FreeVCModule` (WavLM ships separately
    and converts via :func:`convert_wavlm`)."""
    n_flows = 4
    n_wn_layers = 16
    state = fold_weight_norm(state)
    p = {
        "enc_p": {
            "pre": _dense(state, "enc_p.pre"),
            "enc": convert_wn(state, "enc_p.enc.", n_wn_layers, has_cond=False),
            "proj": _dense(state, "enc_p.proj"),
        },
        "enc_q": convert_vits_posterior(
            _subdict(state, "enc_q."), num_layers=n_wn_layers, has_cond=True
        )["params"],
        # freevc interleaves parameterless Flip modules: coupling layers sit
        # at flows.{0,2,4,6} (VITS flips inline, flows.{0..3})
        "flow": convert_vits_flow(
            {
                k.replace(f"flows.{2 * i}.", f"flows.{i}."): v
                for k, v in _subdict(state, "flow.").items()
                for i in [int(k.split(".")[1]) // 2]
            },
            num_flows=n_flows, num_layers=4, has_cond=True,
        )["params"],
        # freevc names its speaker-conditioning conv "cond" (vits: cond_layer)
        "dec": convert_hifigan_generator({
            ("cond_layer." + k[len("cond."):] if k.startswith("cond.") else k): v
            for k, v in _subdict(state, "dec.").items()
        })["params"],
    }
    if "enc_spk.lstm.weight_ih_l0" in state:
        spk = {"linear": _dense(state, "enc_spk.linear")}
        l = 0
        while f"enc_spk.lstm.weight_ih_l{l}" in state:
            spk[f"lstm_{l}"] = _lstm_cell(state, "enc_spk.lstm", f"_l{l}")
            l += 1
        p["enc_spk"] = spk
    return {"params": p}


# ---------------------------------------------------------------------------
# WavLM and FreeVC into the port, and back into the reference layout.
# ---------------------------------------------------------------------------


def wavlm_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``WavLM`` params → the state_dict of the port's
    (``vc/modules/wavlm.py``), by the generic rules."""
    return flax_to_state_dict(params)


def load_reference_wavlm(path: str):
    """A reference WavLM checkpoint file (``{"cfg": ..., "model":
    state_dict}``, read with ``weights_only=True``) → ``(WavLMConfig, the
    port's state_dict)``; the positional conv's weight norm is folded over
    its ``dim=2`` (:func:`_wavlm_fold_pos_conv`)."""
    from tts_tpu_torch.vc.modules.wavlm import WavLMConfig

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = WavLMConfig.from_checkpoint_cfg(dict(ckpt.get("cfg", {})))
    state = {k: _to_numpy(v) for k, v in ckpt["model"].items()}
    return cfg, wavlm_from_jax_params(convert_wavlm_state(state, cfg))


_WAVLM_RULES = (
    (r"^feature_extractor\.conv_(\d+)\.", r"feature_extractor.conv_layers.\1.0."),
    (r"^feature_extractor\.ln_(\d+)\.", r"feature_extractor.conv_layers.\1.2.1."),
    (r"^feature_extractor\.gn_0\.", "feature_extractor.conv_layers.0.2."),
    (r"^pos_conv\.", "encoder.pos_conv.0."),
    (r"^layer_(\d+)\.", r"encoder.layers.\1."),
    (r"\.relative_attention_bias$", ".relative_attention_bias.weight"),
    (r"^encoder_layer_norm\.", "encoder.layer_norm."),
)


def reference_wavlm_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``WavLM`` in the reference's names and
    layouts: the positional conv under weight norm over ``dim=2``
    (``weight_g`` ``[1, 1, k]``, ``weight_v`` scaled per tap, so that only a
    per-tap fold gives the weight back), and the training mask embedding
    ``mask_emb`` the reference holds (zeros; no loader reads it).
    :func:`load_reference_wavlm` maps it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        k = _reference_key(key, _WAVLM_RULES)
        if key == "pos_conv.weight":
            base = k[: -len("weight")]
            taps = np.float32(1) + np.arange(v.shape[2], dtype=np.float32) / v.shape[2]
            out[base + "weight_g"] = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
            out[base + "weight_v"] = v * taps
            out["mask_emb"] = np.zeros(v.shape[0], np.float32)
            continue
        out[k] = v
    return out


def freevc_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``FreeVCModule`` params → the state_dict of the
    port's (``vc/models/freevc.py``): the generic rules, with ``enc_spk``'s
    three flax LSTM cells packed into the layers of one ``nn.LSTM``
    (``enc_spk.lstm.*_l<n>``)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    params = dict(params)
    spk = dict(params.pop("enc_spk", {}))
    state = flax_to_state_dict(params)
    layer = 0
    while f"lstm_{layer}" in spk:
        state.update({f"enc_spk.lstm.{k}": torch.from_numpy(v) for k, v in
                      _pack_lstm(spk.pop(f"lstm_{layer}"), f"_l{layer}").items()})
        layer += 1
    state.update(flax_to_state_dict(spk, "enc_spk."))
    return state


def load_reference_freevc(state: Mapping) -> Dict[str, torch.Tensor]:
    """A reference-layout FreeVC state dict (tensors or arrays) → the
    state_dict of ``FreeVCModule``: weight norm folded, the coupling layers
    read from ``flow.flows.{0,2,4,6}``, ``dec.cond`` as ``dec.cond_layer``,
    ``enc_spk.lstm.*_l<n>`` as one ``nn.LSTM`` (:func:`convert_freevc`).
    Keys the module does not hold (a ``wavlm.*`` copy, say) are not read."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    return freevc_from_jax_params(convert_freevc(state))


_FREEVC_RULES = (
    (r"\.(in_layer|res_skip_layer)\.", r".\1s."),
    (r"^flow\.flow\.(\d+)\.", lambda m: f"flow.flows.{2 * int(m.group(1))}."),
    (r"^dec\.cond_layer\.", "dec.cond."),
)


def reference_freevc_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of ``FreeVCModule`` in the reference's names and
    layouts, weight norm folded: 1x1 convolutions for the linear layers
    (``enc_spk``'s LSTM and Linear stay as they are), the coupling layers at
    ``flow.flows.{0,2,4,6}`` between the reference's parameterless flips,
    the decoder's conditioning conv ``dec.cond``.
    :func:`load_reference_freevc` maps it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        if v.ndim == 2 and not key.startswith("enc_spk."):
            v = v[:, :, None]
        out[_reference_key(key, _FREEVC_RULES)] = v
    return out


# ---------------------------------------------------------------------------
# Tortoise (copied from ``tts_tpu/utils/convert.py:872-905`` and
# ``:1621-1821``, unchanged): the bundled UnivNet, the diffusion decoder, CLVP
# and UnifiedVoice; then the carrier from JAX params and the reference-layout
# writers.
# ---------------------------------------------------------------------------


def convert_tortoise_univnet(state, num_blocks=3, kpnet_res_blocks=3, lvc_convs=4):
    """Tortoise-bundled UnivNet vocoder (reference
    ``TTS/tts/layers/tortoise/vocoder.py:277`` — ``vocoder.pth`` under the
    ``model_g`` subkey).  Use with ``UnivnetGenerator(pad_mode="reflect",
    kpnet_lrelu_slope=0.2, final_lrelu_slope=0.2,
    kpnet_residual_style="per_block", cond_channels=100)``."""
    if "model_g" in state:
        state = state["model_g"]
    state = fold_weight_norm(state)
    p = {
        "first_conv": _plain_conv(state, "conv_pre"),
        "last_conv": _plain_conv(state, "conv_post.1"),
    }
    for i in range(num_blocks):
        k = f"res_stack.{i}"
        blk = {
            "upsample": _convtranspose(state, f"{k}.convt_pre.1"),
            "kernel_predictor": {
                "input_conv": _plain_conv(state, f"{k}.kernel_predictor.input_conv.0"),
                "kernel_conv": _plain_conv(state, f"{k}.kernel_predictor.kernel_conv"),
                "bias_conv": _plain_conv(state, f"{k}.kernel_predictor.bias_conv"),
            },
        }
        for d in range(lvc_convs):
            blk[f"conv_{d}"] = _plain_conv(state, f"{k}.conv_blocks.{d}.1")
        for r in range(kpnet_res_blocks):
            blk["kernel_predictor"][f"res_{r}a"] = _plain_conv(
                state, f"{k}.kernel_predictor.residual_convs.{r}.1"
            )
            blk["kernel_predictor"][f"res_{r}b"] = _plain_conv(
                state, f"{k}.kernel_predictor.residual_convs.{r}.3"
            )
        p[f"lvc_{i}"] = blk
    return {"params": p}


def _tort_gn(state, key):
    return {"scale": state[key + ".weight"], "bias": state[key + ".bias"]}


def _tort_conv(state, key):
    p = {"kernel": conv1d_kernel(state[key + ".weight"])}
    if key + ".bias" in state:
        p["bias"] = state[key + ".bias"]
    return p


def _tort_attn_block(state, key):
    p = {
        "norm": _tort_gn(state, key + ".norm"),
        "qkv": _tort_conv(state, key + ".qkv"),
        "proj_out": _tort_conv(state, key + ".proj_out"),
    }
    rel = key + ".relative_pos_embeddings.relative_attention_bias.weight"
    if rel in state:
        p["relative_attention_bias"] = state[rel]
    return p


def _tort_resblock(state, key):
    p = {
        "in_norm": _tort_gn(state, key + ".in_layers.0"),
        "in_conv": _tort_conv(state, key + ".in_layers.2"),
        "emb": {
            "kernel": linear_kernel(state[key + ".emb_layers.1.weight"]),
            "bias": state[key + ".emb_layers.1.bias"],
        },
        "out_norm": _tort_gn(state, key + ".out_layers.0"),
        "out_conv": _tort_conv(state, key + ".out_layers.3"),
    }
    if key + ".skip_connection.weight" in state:
        p["skip"] = _tort_conv(state, key + ".skip_connection")
    return p


def _tort_diff_layer(state, key):
    return {
        "resblk": _tort_resblock(state, key + ".resblk"),
        "attn": _tort_attn_block(state, key + ".attn"),
    }


def convert_diffusion_decoder(state, num_layers=10) -> Dict[str, Any]:
    """Reference ``DiffusionTts`` state dict → flax params for
    :class:`tts_tpu.models.tortoise.layers.DiffusionTts` (latent path;
    the code_embedding/code_converter training-only branch and the
    mel_head code-pred head are not carried)."""
    p: Dict[str, Any] = {
        "inp_block": _tort_conv(state, "inp_block"),
        "time_embed_0": {
            "kernel": linear_kernel(state["time_embed.0.weight"]),
            "bias": state["time_embed.0.bias"],
        },
        "time_embed_2": {
            "kernel": linear_kernel(state["time_embed.2.weight"]),
            "bias": state["time_embed.2.bias"],
        },
        "integrating_conv": _tort_conv(state, "integrating_conv"),
        "out_norm": _tort_gn(state, "out.0"),
        "out_conv": _tort_conv(state, "out.2"),
        "unconditioned_embedding": np.transpose(state["unconditioned_embedding"], (0, 2, 1)),
        "lat_conv": _tort_conv(state, "latent_conditioner.0"),
        "code_norm": _tort_gn(state, "code_norm"),
        "ctx_conv_0": _tort_conv(state, "contextual_embedder.0"),
        "ctx_conv_1": _tort_conv(state, "contextual_embedder.1"),
    }
    for i in range(4):
        p[f"lat_attn_{i}"] = _tort_attn_block(state, f"latent_conditioner.{i + 1}")
    for i in range(5):
        p[f"ctx_attn_{i}"] = _tort_attn_block(state, f"contextual_embedder.{i + 2}")
    for i in range(3):
        p[f"cti_{i}"] = _tort_diff_layer(state, f"conditioning_timestep_integrator.{i}")
    for i in range(num_layers):
        p[f"layer_{i}"] = _tort_diff_layer(state, f"layers.{i}")
    for i in range(3):
        p[f"post_{i}"] = _tort_resblock(state, f"layers.{num_layers + i}")
    return {"params": p}


def convert_clvp(state, depth=20) -> Dict[str, Any]:
    """Reference ``CLVP`` (use_xformers) state dict → flax params for
    :class:`tts_tpu.models.tortoise.layers.CLVP`."""

    def enc(prefix):
        e: Dict[str, Any] = {}
        for i in range(depth):
            a = f"{prefix}.transformer.attn_layers.layers.{2 * i}"
            f = f"{prefix}.transformer.attn_layers.layers.{2 * i + 1}"
            wrap_a = ".1.wrap" if a + ".1.wrap.to_q.weight" in state else ".1"
            wrap_f = ".1.wrap" if f + ".1.wrap.net.0.proj.weight" in state else ".1"
            e[f"attn_norm_{i}"] = {"g": state[a + ".0.0.g"]}
            e[f"attn_{i}"] = {
                "to_q": {"kernel": linear_kernel(state[a + wrap_a + ".to_q.weight"])},
                "to_k": {"kernel": linear_kernel(state[a + wrap_a + ".to_k.weight"])},
                "to_v": {"kernel": linear_kernel(state[a + wrap_a + ".to_v.weight"])},
                "to_out": {
                    "kernel": linear_kernel(state[a + wrap_a + ".to_out.weight"]),
                    "bias": state[a + wrap_a + ".to_out.bias"],
                },
            }
            e[f"ff_norm_{i}"] = {"g": state[f + ".0.0.g"]}
            e[f"ff_{i}"] = {
                "proj": {
                    "kernel": linear_kernel(state[f + wrap_f + ".net.0.proj.weight"]),
                    "bias": state[f + wrap_f + ".net.0.proj.bias"],
                },
                "out": {
                    "kernel": linear_kernel(state[f + wrap_f + ".net.3.weight"]),
                    "bias": state[f + wrap_f + ".net.3.bias"],
                },
            }
        e["final_norm"] = {
            "scale": state[prefix + ".transformer.norm.weight"],
            "bias": state[prefix + ".transformer.norm.bias"],
        }
        return e

    p = {
        "text_emb": {"embedding": state["text_emb.weight"]},
        "speech_emb": {"embedding": state["speech_emb.weight"]},
        "to_text_latent": {"kernel": linear_kernel(state["to_text_latent.weight"])},
        "to_speech_latent": {"kernel": linear_kernel(state["to_speech_latent.weight"])},
        "temperature": np.asarray(state["temperature"]).reshape(()),
        "text_transformer": enc("text_transformer"),
        "speech_transformer": enc("speech_transformer"),
    }
    return {"params": p}


def convert_unified_voice(state, layers=30) -> Dict[str, Any]:
    """Reference Tortoise ``UnifiedVoice`` state dict → flax params for
    :class:`tts_tpu.models.tortoise.model.UnifiedVoice` (HF GPT2 core via
    ``convert_gpt2_core``; arch_utils attention conditioning encoder)."""
    cond: Dict[str, Any] = {
        "init": {
            "kernel": state["conditioning_encoder.init.weight"][:, :, 0].T,
            "bias": state["conditioning_encoder.init.bias"],
        }
    }
    for i in range(6):
        cond[f"attn_{i}"] = _tort_attn_block(state, f"conditioning_encoder.attn.{i}")
    p: Dict[str, Any] = {
        "conditioning_encoder": cond,
        "text_embedding": {"embedding": state["text_embedding.weight"]},
        "mel_embedding": {"embedding": state["mel_embedding.weight"]},
        "text_pos_embedding": state["text_pos_embedding.emb.weight"],
        "mel_pos_embedding": state["mel_pos_embedding.emb.weight"],
        "gpt": convert_gpt2_core(state, prefix="gpt.", layers=layers),
        "final_norm": {"scale": state["final_norm.weight"], "bias": state["final_norm.bias"]},
        "text_head": {
            "kernel": linear_kernel(state["text_head.weight"]),
            "bias": state["text_head.bias"],
        },
        "mel_head": {
            "kernel": linear_kernel(state["mel_head.weight"]),
            "bias": state["mel_head.bias"],
        },
    }
    return {"params": p}


def tortoise_from_jax_params(ar_params: Mapping, diff_params: Mapping,
                             clvp_params: Mapping = None,
                             vocoder_params: Mapping = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's Tortoise params (``ar_params``, ``diff_params`` and,
    where there are any, ``clvp_params`` and ``vocoder_params``) → the
    state_dicts of the port's ``autoregressive``, ``diffusion``, ``clvp``
    and ``vocoder``, by the generic rules."""
    parts = {"autoregressive": ar_params, "diffusion": diff_params, "clvp": clvp_params,
             "vocoder": vocoder_params}
    return {name: flax_to_state_dict(p) for name, p in parts.items() if p is not None}


def _gpt2_reference_key(key: str) -> str:
    return re.sub(r"\.mlp_(fc|proj)\.", lambda m: f".mlp.c_{m.group(1)}.", key)


def reference_unified_voice_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``UnifiedVoice`` in the reference's names
    and layouts (``autoregressive.pth``): the conditioning encoder's input
    as a 1x1 conv, the position tables under ``.emb``, the GPT's weights as
    HF ``Conv1D`` ``[in, out]``. :func:`convert_unified_voice` maps it back."""
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        if key == "conditioning_encoder.init.weight":
            v = v[:, :, None]
        elif key in ("text_pos_embedding", "mel_pos_embedding"):
            key = key + ".emb.weight"
        elif key.startswith("gpt.h.") and key.endswith("weight") and v.ndim == 2:
            v = v.T  # HF Conv1D
        out[_gpt2_reference_key(key)] = np.ascontiguousarray(v)
    return out


_TORT_BLOCK_RULES = (
    (r"\.in_norm\.", ".in_layers.0."), (r"\.in_conv\.", ".in_layers.2."),
    (r"\.emb\.", ".emb_layers.1."), (r"\.out_norm\.", ".out_layers.0."),
    (r"\.out_conv\.", ".out_layers.3."), (r"\.skip\.", ".skip_connection."),
    (r"\.relative_attention_bias$", ".relative_pos_embeddings.relative_attention_bias.weight"),
)


def reference_diffusion_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``DiffusionTts`` in the reference's names
    (``diffusion_decoder.pth``: ``conditioning_timestep_integrator``,
    ``layers`` with the three post ResBlocks after the diffusion layers,
    ``contextual_embedder``, ``latent_conditioner``, the ``in_layers`` /
    ``emb_layers`` / ``out_layers`` of each ResBlock).
    :func:`convert_diffusion_decoder` maps it back."""
    n_layers = len({k.split(".")[0] for k in state if re.match(r"layer_\d+\.", k)})
    rules = (
        (r"^time_embed_(\d)\.", r"time_embed.\1."),
        (r"^out_norm\.", "out.0."), (r"^out_conv\.", "out.2."),
        (r"^lat_conv\.", "latent_conditioner.0."),
        (r"^lat_attn_(\d+)\.", lambda m: f"latent_conditioner.{int(m.group(1)) + 1}."),
        (r"^ctx_conv_(\d)\.", r"contextual_embedder.\1."),
        (r"^ctx_attn_(\d+)\.", lambda m: f"contextual_embedder.{int(m.group(1)) + 2}."),
        (r"^cti_(\d+)\.", r"conditioning_timestep_integrator.\1."),
        (r"^layer_(\d+)\.", r"layers.\1."),
        (r"^post_(\d+)\.", lambda m: f"layers.{n_layers + int(m.group(1))}."),
    ) + _TORT_BLOCK_RULES
    out = {}
    for key, value in state.items():
        v = value.detach().cpu().numpy()
        if key == "unconditioned_embedding":
            v = np.transpose(v, (0, 2, 1))
        out[_reference_key(key, rules)] = v
    return out


def reference_clvp_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``CLVP`` in the reference's xtransformers
    names (``clvp2.pth``: ``<side>_transformer.transformer.attn_layers.layers``,
    attention at even and feed-forward at odd indices, each ``[norm, block]``,
    and the wrapper's final ``norm``). :func:`convert_clvp` maps it back."""
    rules = (
        (r"^(\w+_transformer)\.attn_norm_(\d+)\.g$",
         lambda m: f"{m.group(1)}.transformer.attn_layers.layers.{2 * int(m.group(2))}.0.0.g"),
        (r"^(\w+_transformer)\.attn\.(\d+)\.",
         lambda m: f"{m.group(1)}.transformer.attn_layers.layers.{2 * int(m.group(2))}.1."),
        (r"^(\w+_transformer)\.ff_norm_(\d+)\.g$",
         lambda m: f"{m.group(1)}.transformer.attn_layers.layers.{2 * int(m.group(2)) + 1}.0.0.g"),
        (r"^(\w+_transformer)\.ff_(\d+)\.proj\.",
         lambda m: f"{m.group(1)}.transformer.attn_layers.layers.{2 * int(m.group(2)) + 1}"
                   f".1.net.0.proj."),
        (r"^(\w+_transformer)\.ff_(\d+)\.out\.",
         lambda m: f"{m.group(1)}.transformer.attn_layers.layers.{2 * int(m.group(2)) + 1}"
                   f".1.net.3."),
        (r"^(\w+_transformer)\.final_norm\.", r"\1.transformer.norm."),
    )
    return {_reference_key(k, rules): v.detach().cpu().numpy() for k, v in state.items()}


_TORT_UNIVNET_RULES = (
    (r"^first_conv\.", "conv_pre."), (r"^last_conv\.", "conv_post.1."),
    (r"^lvc_(\d+)\.upsample\.", r"res_stack.\1.convt_pre.1."),
    (r"^lvc_(\d+)\.conv_(\d+)\.", r"res_stack.\1.conv_blocks.\2.1."),
    (r"^lvc_(\d+)\.kernel_predictor\.input_conv\.", r"res_stack.\1.kernel_predictor.input_conv.0."),
    (r"^lvc_(\d+)\.kernel_predictor\.res_(\d+)a\.",
     r"res_stack.\1.kernel_predictor.residual_convs.\2.1."),
    (r"^lvc_(\d+)\.kernel_predictor\.res_(\d+)b\.",
     r"res_stack.\1.kernel_predictor.residual_convs.\2.3."),
    (r"^lvc_(\d+)\.kernel_predictor\.", r"res_stack.\1.kernel_predictor."),
)


def reference_tortoise_univnet_state(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The state_dict of the port's bundled ``UnivnetGenerator`` as the
    reference's ``vocoder.pth`` holds it: ``{"model_g": state}`` in the
    names of ``tortoise/vocoder.py`` (``conv_pre``, ``res_stack``,
    ``convt_pre``, ``conv_blocks``, ``residual_convs``, ``conv_post``).
    :func:`convert_tortoise_univnet` maps it back."""
    return {"model_g": {_reference_key(k, _TORT_UNIVNET_RULES): v.detach().cpu().numpy()
                        for k, v in state.items()}}


# ---------------------------------------------------------------------------
# Bark. Copied from ``tts_tpu/utils/convert.py``: the EnCodec converters
# (``:1135-1253``) and the Bark GPT converters (``:1793-1850``), unchanged.
# ---------------------------------------------------------------------------


def _normalize_encodec_keys(state):
    """Map the original ``encodec`` package state-dict names onto the HF
    ``EncodecModel`` ones (same structure, different nesting)."""
    out = {}
    for k, v in state.items():
        k = k.replace("decoder.model.", "decoder.layers.")
        k = k.replace("encoder.model.", "encoder.layers.")
        k = k.replace(".conv.conv.", ".conv.")
        k = k.replace(".convtr.convtr.", ".conv.")
        k = k.replace("quantizer.vq.layers.", "quantizer.layers.")
        k = k.replace("._codebook.", ".codebook.")
        out[k] = v
    return out


def convert_encodec_decoder(state, upsampling_ratios=(8, 5, 4, 2),
                            num_residual_layers=1, num_lstm_layers=2,
                            num_quantizers=None):
    """HF ``EncodecModel`` (or original ``encodec``) state dict → flax
    ``EncodecDecoder`` params + RVQ codebooks.

    Returns ``(params, codebooks [n_q, bins, D])`` — encoder weights are
    ignored (Bark only decodes).
    """
    state = fold_weight_norm(_normalize_encodec_keys(state))
    p = {
        "layer_0": {"conv": _plain_conv(state, "decoder.layers.0.conv")},
    }
    for l in range(num_lstm_layers):
        p[f"lstm_{l}"] = _lstm_cell(state, "decoder.layers.1.lstm", f"_l{l}")
    idx = 2
    for _ in upsampling_ratios:
        idx += 1  # ELU
        p[f"layer_{idx}"] = {
            "conv": _convtranspose(state, f"decoder.layers.{idx}.conv")
        }
        for _ in range(num_residual_layers):
            idx += 1
            p[f"layer_{idx}"] = {
                "block_1": {"conv": _plain_conv(state, f"decoder.layers.{idx}.block.1.conv")},
                "block_3": {"conv": _plain_conv(state, f"decoder.layers.{idx}.block.3.conv")},
                "shortcut": {"conv": _plain_conv(state, f"decoder.layers.{idx}.shortcut.conv")},
            }
        idx += 1
    idx += 1
    p[f"layer_{idx}"] = {"conv": _plain_conv(state, f"decoder.layers.{idx}.conv")}

    cb_keys = sorted(
        (k for k in state if k.startswith("quantizer.layers.") and k.endswith(".codebook.embed")),
        key=lambda k: int(k.split(".")[2]),
    )
    if num_quantizers is not None:
        cb_keys = cb_keys[:num_quantizers]
    codebooks = np.stack([state[k] for k in cb_keys]) if cb_keys else None
    return {"params": p}, codebooks


def infer_encodec_dims(state) -> Dict[str, object]:
    """Read the SEANet hyperparameters straight off a checkpoint so
    reduced-dim test models and the real 24 kHz weights both load without
    out-of-band configuration.  Returns kwargs for ``EncodecDecoder`` /
    ``EncodecEncoder``."""
    import re as _re

    state = fold_weight_norm(_normalize_encodec_keys(state))
    convs = sorted(
        int(k.split(".")[2])
        for k in state
        if _re.match(r"decoder\.layers\.\d+\.conv\.weight$", k)
    )
    # [in-conv, upsample×len(ratios), out-conv]
    w0 = state[f"decoder.layers.{convs[0]}.conv.weight"]  # [scaling*nf, hidden, K]
    ups = convs[1:-1]
    ratios = [int(state[f"decoder.layers.{i}.conv.weight"].shape[2]) // 2 for i in ups]
    # gap between consecutive upsample convs = 1 ELU + num_res resblocks + 1
    num_res = (ups[1] - ups[0] - 2) if len(ups) > 1 else 1
    res_key = f"decoder.layers.{ups[0] + 1}.block.1.conv.weight"
    lstm_layers = sum(
        1 for k in state if k.startswith("decoder.layers.1.lstm.weight_ih_l")
    )
    return dict(
        hidden_size=int(w0.shape[1]),
        num_filters=int(w0.shape[0]) // (2 ** len(ratios)),
        upsampling_ratios=tuple(ratios),
        kernel_size=int(w0.shape[2]),
        last_kernel_size=int(state[f"decoder.layers.{convs[-1]}.conv.weight"].shape[2]),
        residual_kernel_size=int(state[res_key].shape[2]) if res_key in state else 3,
        num_lstm_layers=lstm_layers,
        num_residual_layers=max(1, num_res),
    )


def convert_encodec_encoder(state, upsampling_ratios=(8, 5, 4, 2),
                            num_residual_layers=1, num_lstm_layers=2):
    """HF/original EnCodec state dict → flax ``EncodecEncoder`` params
    (``encoder.layers.*``, same ModuleList-index naming as the decoder)."""
    state = fold_weight_norm(_normalize_encodec_keys(state))
    p = {
        "layer_0": {"conv": _plain_conv(state, "encoder.layers.0.conv")},
    }
    idx = 0
    for _ in reversed(list(upsampling_ratios)):
        for _ in range(num_residual_layers):
            idx += 1
            p[f"layer_{idx}"] = {
                "block_1": {"conv": _plain_conv(state, f"encoder.layers.{idx}.block.1.conv")},
                "block_3": {"conv": _plain_conv(state, f"encoder.layers.{idx}.block.3.conv")},
                "shortcut": {"conv": _plain_conv(state, f"encoder.layers.{idx}.shortcut.conv")},
            }
        idx += 2  # ELU + strided conv
        p[f"layer_{idx}"] = {"conv": _plain_conv(state, f"encoder.layers.{idx}.conv")}
    lstm_idx = idx + 1
    for l in range(num_lstm_layers):
        p[f"lstm_{l}"] = _lstm_cell(state, f"encoder.layers.{lstm_idx}.lstm", f"_l{l}")
    out_idx = lstm_idx + 2
    p[f"layer_{out_idx}"] = {"conv": _plain_conv(state, f"encoder.layers.{out_idx}.conv")}
    return {"params": p}


def _bark_ln(state, key):
    p = {"scale": state[key + ".weight"]}
    if key + ".bias" in state and state[key + ".bias"] is not None:
        p["bias"] = state[key + ".bias"]
    return p


def _bark_linear(state, key):
    p = {"kernel": linear_kernel(state[key + ".weight"])}
    if key + ".bias" in state:
        p["bias"] = state[key + ".bias"]
    return p


def _bark_core(state, n_layer):
    core = {"ln_f": _bark_ln(state, "transformer.ln_f")}
    for i in range(n_layer):
        k = f"transformer.h.{i}"
        core[f"h_{i}"] = {
            "ln_1": _bark_ln(state, f"{k}.ln_1"),
            "ln_2": _bark_ln(state, f"{k}.ln_2"),
            "attn": {
                "c_attn": _bark_linear(state, f"{k}.attn.c_attn"),
                "c_proj": _bark_linear(state, f"{k}.attn.c_proj"),
            },
            "mlp_fc": _bark_linear(state, f"{k}.mlp.c_fc"),
            "mlp_proj": _bark_linear(state, f"{k}.mlp.c_proj"),
        }
    return core


def convert_bark_gpt(state, n_layer=12) -> Dict[str, Any]:
    """Reference Bark ``GPT`` (semantic/coarse) → flax params for
    :class:`tts_tpu.models.bark.model.BarkGPT`."""
    return {
        "params": {
            "wte": {"embedding": state["transformer.wte.weight"]},
            "wpe": state["transformer.wpe.weight"],
            "core": _bark_core(state, n_layer),
            "lm_head": {"kernel": linear_kernel(state["lm_head.weight"])},
        }
    }


def convert_bark_fine(state, n_layer=12, n_codes_total=8, n_codes_given=1) -> Dict[str, Any]:
    """Reference Bark ``FineGPT`` → flax params for ``BarkFineGPT``."""
    p: Dict[str, Any] = {
        "wpe": state["transformer.wpe.weight"],
        "core": _bark_core(state, n_layer),
    }
    for i in range(n_codes_total):
        p[f"wte_{i}"] = {"embedding": state[f"transformer.wtes.{i}.weight"]}
    for i in range(n_codes_total - n_codes_given):
        # flax heads are named by the codebook they predict (offset by
        # n_codes_given); the reference list starts at 0
        p[f"lm_head_{i + n_codes_given}"] = {
            "kernel": linear_kernel(state[f"lm_heads.{i}.weight"])
        }
    return {"params": p}


# ---------------------------------------------------------------------------
# Bark into the port, and back into the reference layout.
# ---------------------------------------------------------------------------


def _upsample_layers(upsampling_ratios, num_residual_layers) -> Tuple[str, ...]:
    """The EnCodec decoder's transposed convs, by their HF ModuleList index."""
    names, idx = [], 2
    for _ in upsampling_ratios:
        names.append(f"layer_{idx + 1}")
        idx += num_residual_layers + 2
    return tuple(names)


def encodec_from_jax_params(params: Mapping, codebooks=None, upsampling_ratios=None,
                            num_residual_layers: int = 1) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncodecDecoder`` or ``EncodecEncoder`` params →
    the state_dict of the port's (``models/bark/encodec.py``): the generic
    rules, with the cells ``lstm_<l>`` packed into the layers of one
    ``nn.LSTM`` and, for a decoder (``upsampling_ratios`` given), the
    transposed convs' time-flipped ``[k, in, out]`` kernels turned back into
    ``ConvTranspose1d``'s ``[in, out, k]``. ``codebooks [n_q, bins, D]``
    become the ``codebooks`` buffer of an ``EncodecVocoder``'s state (keys
    then under ``decoder.``)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    state = flax_to_state_dict({k: v for k, v in params.items() if not k.startswith("lstm_")})
    for name in _upsample_layers(upsampling_ratios or (), num_residual_layers):
        k = np.asarray(params[name]["conv"]["kernel"], np.float32)
        state[f"{name}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(1, 2, 0)[:, :, ::-1]))
    for key, cell in params.items():
        if key.startswith("lstm_"):
            state.update({f"lstm.{leaf}": torch.from_numpy(w)
                          for leaf, w in _pack_lstm(cell, f"_l{key[5:]}").items()})
    if codebooks is not None:
        state = {"decoder." + k: v for k, v in state.items()}
        state["codebooks"] = torch.from_numpy(np.array(codebooks, np.float32))
    return state


def bark_from_jax_params(semantic_params: Mapping, coarse_params: Mapping, fine_params: Mapping,
                         encodec=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's Bark params (the three GPTs' and, where there is
    one, its ``EncodecVocoder``) → the state_dicts of the port's
    ``semantic_model``, ``coarse_model``, ``fine_model`` (the generic rules)
    and ``encodec`` (decoder, codebooks and, where the JAX vocoder holds
    them, the encoder: :func:`encodec_from_jax_params`)."""
    states = {"semantic_model": flax_to_state_dict(semantic_params),
              "coarse_model": flax_to_state_dict(coarse_params),
              "fine_model": flax_to_state_dict(fine_params)}
    if encodec is not None:
        dec = encodec.decoder
        state = encodec_from_jax_params(encodec.params, np.asarray(encodec.codebooks),
                                        dec.upsampling_ratios, dec.num_residual_layers)
        if encodec.encoder_params is not None:
            state.update({"encoder." + k: v for k, v in
                          encodec_from_jax_params(encodec.encoder_params).items()})
        states["encodec"] = state
    return states


def load_reference_encodec(state: Mapping, device="cuda"):
    """A reference EnCodec state dict (HF ``EncodecModel`` or the
    ``encodec`` package's, numpy) → the port's ``EncodecVocoder`` on
    ``device`` (the card unless the CPU is asked for), its SEANet dims read
    off the checkpoint; the encoder too where the checkpoint holds it."""
    from tts_tpu_torch import resolve_device
    from tts_tpu_torch.models.bark.encodec import EncodecDecoder, EncodecEncoder, EncodecVocoder

    device = resolve_device(device)

    dims = infer_encodec_dims(state)
    kw = dict(upsampling_ratios=dims["upsampling_ratios"],
              num_residual_layers=dims["num_residual_layers"],
              num_lstm_layers=dims["num_lstm_layers"])
    params, codebooks = convert_encodec_decoder(state, **kw)
    has_encoder = any(k.startswith(("encoder.layers.", "encoder.model.")) for k in state)
    with torch.device("meta"):
        vocoder = EncodecVocoder(EncodecDecoder(**dims), torch.empty(codebooks.shape),
                                 EncodecEncoder(**dims) if has_encoder else None)
    weights = encodec_from_jax_params(params, codebooks, kw["upsampling_ratios"],
                                      kw["num_residual_layers"])
    if has_encoder:
        weights.update({"encoder." + k: v for k, v in
                        encodec_from_jax_params(convert_encodec_encoder(state, **kw)).items()})
    vocoder.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True,
                            assign=True)
    return vocoder.eval().requires_grad_(False)


def hubert_tokenizer_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``HubertTokenizer`` params → the state_dict of the
    port's (``models/bark/hubert.py``): ``lstm0``/``lstm1`` packed into the
    two layers of one ``nn.LSTM``, the Denses by the generic rules."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    state = flax_to_state_dict({k: v for k, v in params.items() if not k.startswith("lstm")})
    for key in ("lstm0", "lstm1"):
        state.update({f"lstm.{leaf}": torch.from_numpy(w)
                      for leaf, w in _pack_lstm(params[key], f"_l{key[-1]}").items()})
    return state


def reference_bark_gpt_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``BarkGPT`` or ``BarkFineGPT`` in the
    reference's nanoGPT names (``transformer.wte``/``wtes.<i>``, ``wpe``,
    ``h.<i>.attn.c_attn``, ``mlp.c_fc``, ``ln_f``; ``lm_head`` or
    ``lm_heads.<i - n_codes_given>``), as ``text_2.pt``, ``coarse_2.pt`` and
    ``fine_2.pt`` hold it under ``"model"``. :func:`convert_bark_gpt` and
    :func:`convert_bark_fine` map it back."""
    heads = sorted(int(k.split(".")[0][8:]) for k in state if re.match(r"lm_head_\d+\.", k))
    rules = (
        (r"^wte\.", "transformer.wte."), (r"^wte_(\d+)\.", r"transformer.wtes.\1."),
        (r"^wpe$", "transformer.wpe.weight"), (r"^core\.", "transformer."),
        (r"\.mlp_(fc|proj)\.", r".mlp.c_\1."),
        (r"^lm_head_(\d+)\.", lambda m: f"lm_heads.{int(m.group(1)) - heads[0]}."),
    )
    return {_reference_key(k, rules): v.detach().float().cpu().numpy() for k, v in state.items()}


def reference_encodec_state(state: Mapping[str, torch.Tensor],
                            num_lstm_layers: int = 2) -> Dict[str, np.ndarray]:
    """The state_dict of the port's ``EncodecVocoder`` in HF
    ``EncodecModel``'s names (``decoder.layers.<i>.conv``, the LSTM at
    ``decoder.layers.1.lstm``, the encoder's after its last strided conv,
    ``quantizer.layers.<q>.codebook.embed``; weights plain, without weight
    norm, which the converters accept). :func:`load_reference_encodec` maps
    it back."""
    enc_lstm = None
    enc_convs = [int(m.group(1)) for k in state
                 if (m := re.match(r"encoder\.layer_(\d+)\.conv\.weight$", k))]
    if enc_convs:
        enc_lstm = max(enc_convs) - 2
    out = {}
    for key, value in state.items():
        v = value.detach().float().cpu().numpy()
        if key == "codebooks":
            for q in range(v.shape[0]):
                out[f"quantizer.layers.{q}.codebook.embed"] = np.ascontiguousarray(v[q])
            continue
        key = re.sub(r"^decoder\.lstm\.", "decoder.layers.1.lstm.", key)
        key = re.sub(r"^encoder\.lstm\.", f"encoder.layers.{enc_lstm}.lstm.", key)
        key = re.sub(r"\.layer_(\d+)\.", r".layers.\1.", key)
        key = re.sub(r"\.block_(\d)\.conv\.", r".block.\1.conv.", key)
        out[key] = v
    return out
