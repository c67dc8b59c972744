"""Tacotron2 inference (port of ``tts_tpu/models/tacotron2/model.py``,
reference ``TTS/tts/models/tacotron2.py`` + ``base_tacotron.py``):
``Tacotron2Module`` (embedding, encoder, decoder cell, postnet; the
teacher-forced ``forward`` and the free-running ``inference``) and the
``Tacotron2`` host wrapper (tokenizer, weights, reduction factor).

The JAX package scans the decoder cell over a static ``max_steps`` and masks
each row's frames after its first stop (``sigmoid(stop) > 0.5``, the row
still counting the step that stopped it). The port loops eagerly and leaves
once every row has stopped, reading the rows' stop flags back to the host
every :data:`STOP_CHECK_EVERY` steps: steps after the last stop are masked
to zeros in the JAX package, so leaving early changes no valid frame. The
decoder output is padded with zeros to ``max_steps × r`` frames before the
postnet, which sees the JAX package's zeros there, so the valid frames of
``model_outputs`` equal the JAX package's. ``alignments`` and
``stop_tokens`` cover only the steps that ran.

Reduction factor (ROADMAP.md F20): the projection is sized ``80 × r_init``
and a step emits its first ``80 × r`` frames. ``load_checkpoint`` takes
``r_init`` from the checkpoint's projection and ``r`` from the checkpoint's
own ``r`` where it has one, else from the config; the JAX package takes both
from ``config.r``.

Style (JAX ``_encode``, ``model.py:150-178``): after the speaker embedding
or d-vector, a GST model appends its style vector (of ``aux_input
["style_mel"]``, or zeros without one), then a Capacitron model its prosody
vector ``z``, computed on the encoder outputs as they stand after the
earlier appends: drawn from the posterior of the style mel and the text's
summary, or from the prior without a style mel. Each vector is broadcast
over the tokens. ``aux_input["style_text"]`` is read by nothing, as in the
JAX package (ROADMAP.md F37). The draw ``eps`` is an argument; without one
the wrapper draws it on the host from a generator seeded 0 at each call, as
the JAX wrapper keys each call with one fixed noise key.

The DDC coarse decoder, the losses and the gradual-training schedule serve
training and wait for it (ROADMAP.md item 17).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.capacitron import CapacitronVAE
from tts_tpu_torch.layers.tacotron import (
    ConvBNBlock,
    Postnet,
    Tacotron2DecoderCell,
    Tacotron2Encoder,
)
from tts_tpu_torch.layers.tacotron_v1 import GST
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import sequence_mask
from tts_tpu_torch.text.tokenizer import TTSTokenizer

from .config import Tacotron2Config

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of Tacotron2Module
REFERENCE_WEIGHTS = ("model_file.pth", "model.pth")  # reference-layout (coqui) checkpoints
PROJECTION = "decoder_cell.linear_projection.weight"  # [out_channels × r_init, in]

# decode steps between two reads of the rows' stop flags: each read waits
# for the device, and a step costs less than that wait
STOP_CHECK_EVERY = 8


def speaker_channels(config: Tacotron2Config) -> int:
    """The width appended to the encoder outputs for the speaker: the speaker
    embedding's, or the d-vectors', or 0."""
    if config.use_speaker_embedding and config.num_speakers > 1:
        return config.speaker_embedding_dim
    if config.use_d_vector_file:
        return config.d_vector_dim
    return 0


def gst_settings(config) -> Dict[str, int]:
    """The GST's heads, tokens and width: the config's ``gst`` dict over the
    JAX package's defaults (4, 10, 512; ``model.py:396-404``)."""
    gst = getattr(config, "gst", None) or {}
    return {"num_heads": gst.get("gst_num_heads", 4),
            "num_style_tokens": gst.get("gst_num_style_tokens", 10),
            "gst_embedding_dim": gst.get("gst_embedding_dim", 512)}


def capacitron_dim(config) -> int:
    """The width of Capacitron's ``z`` (``capacitron_VAE_embedding_dim`` of
    the config's ``capacitron_vae`` dict, 128 by default)."""
    return (getattr(config, "capacitron_vae", None) or {}).get("capacitron_VAE_embedding_dim",
                                                              128)


def broadcast_concat(enc: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """``vec`` ``[B, D]`` appended to every token of ``enc`` ``[B, T, C]``."""
    return torch.cat([enc, vec[:, None, :].expand(-1, enc.shape[1], -1)], dim=-1)


def free_run(cell: Tacotron2DecoderCell, enc, processed, input_mask, max_steps: int,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """At most ``max_steps`` free-running steps of ``cell`` over the encoder
    outputs ``enc``, each fed the last frame of the one before, leaving once
    every row has stopped (read every :data:`STOP_CHECK_EVERY` steps).
    Returns the frames of the steps that ran as ``decoder_outputs`` ``[B,
    steps × r, C]``, zero after each row's stop, their mask ``valid`` ``[B,
    steps × r, 1]``, ``alignments``, ``stop_tokens`` and ``mel_lengths``."""
    B, T_in = input_mask.shape
    r, C = cell.r, cell.frame_channels
    carry = cell.init_carry(B, T_in, enc.shape[-1], enc.device)
    prev = torch.zeros(B, C, device=enc.device)
    finished = torch.zeros(B, dtype=torch.bool, device=enc.device)
    outputs, stops, aligns, active = [], [], [], []
    for step in range(max_steps):
        carry, (out, stop, align) = cell(carry, prev, enc, processed, input_mask, generator)
        outputs.append(out)
        stops.append(stop)
        aligns.append(align)
        active.append(~finished)
        finished = finished | (torch.sigmoid(stop) > 0.5)
        prev = out[:, (r - 1) * C:]
        if (step + 1) % STOP_CHECK_EVERY == 0 and bool(finished.all()):
            break
    active = torch.stack(active, 1)  # [B, steps]: the step ran before the row's stop
    valid = active.repeat_interleave(r, dim=1)[:, :, None].float()
    return {"decoder_outputs": torch.stack(outputs, 1).reshape(B, -1, C) * valid,
            "valid": valid, "alignments": torch.stack(aligns, 1),
            "stop_tokens": torch.stack(stops, 1), "mel_lengths": active.sum(1) * r}


class Tacotron2Module(nn.Module):
    """The Tacotron2 network; ``r_init`` sizes the projection (``config.r``
    when not given), ``config.r`` is the decode's reduction factor."""

    def __init__(self, config: Tacotron2Config, r_init: Optional[int] = None):
        super().__init__()
        self.out_channels = config.out_channels
        self.use_speaker_embedding = config.use_speaker_embedding and config.num_speakers > 1
        in_channels = config.encoder_in_features + speaker_channels(config)
        if config.use_gst:
            gst = gst_settings(config)
            self.gst_dim = gst["gst_embedding_dim"]
            self.gst_layer = GST(config.out_channels, norm_type=config.norm_type, **gst)
            in_channels += self.gst_dim
        if config.use_capacitron_vae:
            self.capacitron_vae_layer = CapacitronVAE(
                config.out_channels, in_channels, capacitron_dim(config),
                norm_type=config.norm_type)
            in_channels += capacitron_dim(config)
        self.embedding = nn.Embedding(config.num_chars, config.embedding_dim)
        self.encoder = Tacotron2Encoder(config.embedding_dim, config.encoder_in_features,
                                        config.norm_type)
        self.decoder_cell = Tacotron2DecoderCell(
            in_channels=in_channels, frame_channels=config.out_channels, r=config.r,
            r_init=r_init or config.r, query_dim=config.query_dim,
            decoder_rnn_dim=config.decoder_rnn_dim, prenet_dim=config.prenet_dim,
            attn_dim=config.attn_dim, prenet_type=config.prenet_type,
            prenet_dropout=config.prenet_dropout,
            prenet_dropout_at_inference=config.prenet_dropout_at_inference,
            location_attn=config.location_attn, attn_norm=config.attention_norm,
            attn_type=config.attention_type, attn_K=config.attention_heads,
            use_forward_attn=config.use_forward_attn, trans_agent=config.transition_agent,
            attn_win=config.attention_win)
        self.inputs_layer = nn.Linear(in_channels, config.attn_dim, bias=False)
        self.postnet = Postnet(config.out_channels, norm_type=config.norm_type)
        if self.use_speaker_embedding:
            self.speaker_embedding = nn.Embedding(config.num_speakers,
                                                  config.speaker_embedding_dim)

    @property
    def r(self) -> int:
        return self.decoder_cell.r

    def _encode(self, text, text_lengths, aux_input: Optional[Dict] = None, style_mel=None,
                style_lengths=None, eps=None, generator=None):
        """Encoder outputs ``[B, T_in, C]``, with the speaker embedding (from
        ``speaker_ids``) or the d-vector, then the GST style vector of
        ``style_mel`` (zeros without one), then Capacitron's ``z`` (posterior
        of ``style_mel``, else the prior; ``eps`` or a draw from
        ``generator``) appended to every token."""
        x_mask = sequence_mask(text_lengths, text.shape[1])[:, :, None].float()
        enc = self.encoder(self.embedding(text), x_mask)
        aux_input = aux_input or {}
        if self.use_speaker_embedding and aux_input.get("speaker_ids") is not None:
            enc = broadcast_concat(enc, self.speaker_embedding(aux_input["speaker_ids"]))
        elif aux_input.get("d_vectors") is not None:
            enc = broadcast_concat(enc, aux_input["d_vectors"])
        if hasattr(self, "gst_layer"):
            enc = broadcast_concat(enc, self.gst_layer(style_mel) if style_mel is not None
                                   else enc.new_zeros(enc.shape[0], self.gst_dim))
        if hasattr(self, "capacitron_vae_layer"):
            enc = broadcast_concat(enc, self.capacitron_vae_layer(
                style_mel, enc, text_lengths=text_lengths, mel_lengths=style_lengths, eps=eps,
                generator=generator))
        return enc

    def _attention_inputs(self, enc):
        """The ``inputs_layer`` projection the location-sensitive attention
        reads (Graves and DCA read none)."""
        return self.inputs_layer(enc) if self.decoder_cell.attn_type == "original" else None

    def forward(self, text, text_lengths, mel_specs, aux_input: Optional[Dict] = None,
                mel_lengths=None, eps=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced decode (reference ``tacotron2.py`` forward): the
        mel is grouped by ``r`` frames and the prenet of each step sees the
        last frame of the previous group (reference
        ``Decoder._update_memory``, ``tacotron2.py:246``). A style model
        takes its style from ``mel_specs`` itself (Capacitron within
        ``mel_lengths``), as the JAX forward does."""
        B, T_in = text.shape
        r, C = self.r, self.out_channels
        styled = hasattr(self, "gst_layer") or hasattr(self, "capacitron_vae_layer")
        enc = self._encode(text, text_lengths, aux_input, mel_specs if styled else None,
                           mel_lengths, eps)
        input_mask = sequence_mask(text_lengths, T_in)
        processed = self._attention_inputs(enc)
        T_de = mel_specs.shape[1] // r
        frames = mel_specs[:, : T_de * r].reshape(B, T_de, r * C)[:, :, (r - 1) * C:]
        memories = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], dim=1)
        carry = self.decoder_cell.init_carry(B, T_in, enc.shape[-1], enc.device)
        outputs, stops, aligns = [], [], []
        for t in range(T_de):
            carry, (out, stop, align) = self.decoder_cell(carry, memories[:, t], enc, processed,
                                                          input_mask)
            outputs.append(out)
            stops.append(stop)
            aligns.append(align)
        decoder_outputs = torch.stack(outputs, 1).reshape(B, T_de * r, C)
        return {
            "model_outputs": decoder_outputs + self.postnet(decoder_outputs),
            "decoder_outputs": decoder_outputs,
            "alignments": torch.stack(aligns, 1),
            "stop_tokens": torch.stack(stops, 1).repeat_interleave(r, dim=1),
        }

    def inference(self, text, text_lengths, aux_input: Optional[Dict] = None,
                  max_steps: int = 500, generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  style_generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Free-running decode of at most ``max_steps`` steps of ``r``
        frames. Returns ``model_outputs`` and ``decoder_outputs`` ``[B,
        max_steps × r, C]`` (zero after each row's ``mel_lengths`` frames),
        and ``alignments`` ``[B, steps, T_in]`` and ``stop_tokens`` ``[B,
        steps]`` over the steps that ran. ``generator`` draws the prenet's
        dropout where the config keeps it at inference; Capacitron's ``z``
        takes ``eps``, else draws from ``style_generator`` (a CPU generator).
        The style comes from ``aux_input["style_mel"]``."""
        enc = self._encode(text, text_lengths, aux_input, (aux_input or {}).get("style_mel"),
                           eps=eps, generator=style_generator)
        out = free_run(self.decoder_cell, enc, self._attention_inputs(enc),
                       sequence_mask(text_lengths, text.shape[1]), max_steps, generator)
        pad = (0, 0, 0, max_steps * self.r - out["decoder_outputs"].shape[1])
        valid = nn.functional.pad(out.pop("valid"), pad)
        decoder_outputs = nn.functional.pad(out["decoder_outputs"], pad)
        return {**out, "model_outputs": decoder_outputs + self.postnet(decoder_outputs) * valid,
                "decoder_outputs": decoder_outputs}


_FOLDED = re.compile(r"(^|\.)(scale|shift)_\d+$")  # a folded norm's affine


@torch.no_grad()
def draw_params(module: nn.Module, seed: int) -> None:
    """Random fp32 weights from ``seed``, drawn on the CPU (the same on every
    machine) into ``module``, which is materialised there: linear, conv and
    recurrent weights N(0, 1/fan_in), biases 0 (a highway's ``T`` bias −1),
    norm scales 1 and shifts 0, token embeddings N(0, 0.3²) and style tokens
    N(0, 0.5²) (the JAX package's initialisers), Capacitron's ``beta`` at
    softplus⁻¹(1)."""
    gen = torch.Generator().manual_seed(seed)
    module.to_empty(device="cpu")
    for name, p in module.named_parameters():
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = module.get_submodule(owner_name)
        if isinstance(owner, (nn.LayerNorm, ConvBNBlock)) or _FOLDED.search(name):
            p.fill_(1.0 if leaf.startswith(("weight", "scale")) else 0.0)
        elif leaf == "beta":
            p.fill_(math.log(math.e - 1.0))
        elif "bias" in leaf:
            p.fill_(-1.0 if name.endswith(".T.bias") else 0.0)
        elif isinstance(owner, nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        elif leaf == "style_tokens":
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        else:
            p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)


class Tacotron2:
    """Host wrapper: tokenizer, weights and reduction factor around
    :class:`Tacotron2Module`."""

    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: Tacotron2Config):
        self.config = config
        self.r_init = config.r  # the projection's width stays fixed across set_r
        self.module = Tacotron2Module(config)
        self.tokenizer: Optional[TTSTokenizer] = None

    @classmethod
    def init_from_config(cls, config: Tacotron2Config) -> "Tacotron2":
        """Tokenizer and model for ``config``. The embedding has the
        vocabulary's size when ``num_chars`` is ``None``; a smaller
        ``num_chars`` raises (ROADMAP.md F7)."""
        tokenizer, config = init_tokenizer(config)
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.embedding.weight.device

    @property
    def hop_length(self) -> int:
        return int(self.config.audio.hop_length)

    @property
    def r(self) -> int:
        """The decode's reduction factor: frames per decoder step."""
        return self.module.r

    def set_r(self, r: int) -> None:
        """Decode ``r`` frames a step without changing parameter shapes
        (reference ``Decoder.set_r``, ``tacotron2.py:211``)."""
        if not 1 <= r <= self.r_init:
            raise ValueError(f"r={r} outside 1..r_init={self.r_init}")
        self.module.decoder_cell.r = r
        self.config.r = r

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda") -> "Tacotron2":
        """Random fp32 weights from ``seed`` (:func:`draw_params`), moved to
        ``device``."""
        draw_params(self.module, seed)
        self.module.to(resolve_device(device)).requires_grad_(False)
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra).
        The module is built anew (on the meta device) when the state's
        projection gives another ``r_init`` or its norms another
        ``norm_type`` than the module has; the config takes that
        ``norm_type``."""
        r_init = state[PROJECTION].shape[0] // self.config.out_channels
        norm_type = "folded" if "encoder.conv_0.weight" in state else "layer"
        built = "layer" if hasattr(self.module.encoder.conv_0, "norm") else "folded"
        self.config.norm_type = norm_type
        if r_init != self.r_init or norm_type != built:
            self.r_init = r_init
            with torch.device("meta"):
                self.module = Tacotron2Module(self.config, r_init)
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)

    def load_checkpoint(self, config: Tacotron2Config, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "Tacotron2":
        """Weights from a file: the port's state_dict of
        :class:`Tacotron2Module` (``model_torch.pt``) or a reference-layout
        checkpoint (``model_file.pth`` or ``model.pth``: its BatchNorms
        folded, ``norm_type`` set to ``"folded"`` as the JAX package's zoo
        conversion sets it). ``checkpoint_dir`` looks for those names in
        turn. A file of the form ``{"model": state, "r": r}`` decodes at its
        ``r``; otherwise at ``config.r``."""
        device = resolve_device(device)
        if checkpoint_path is None:
            for name in (PORT_WEIGHTS,) + REFERENCE_WEIGHTS:
                if os.path.isfile(os.path.join(checkpoint_dir, name)):
                    checkpoint_path = os.path.join(checkpoint_dir, name)
                    break
            else:
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS} or one of {REFERENCE_WEIGHTS})")
        checkpoint = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        state, r = checkpoint, None
        if isinstance(checkpoint, dict) and "model" in checkpoint:
            state, r = checkpoint["model"], checkpoint.get("r")
        if PROJECTION not in state:
            from tts_tpu_torch.utils.convert import load_reference_tacotron2

            state = load_reference_tacotron2(state, self.config)
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        self.set_r(int(r) if r is not None else self.config.r)
        return self

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_steps: int = 500, aux_input: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Text ids → mel (:meth:`Tacotron2Module.inference`). Where the
        config keeps the prenet's dropout at inference, its masks come from
        ``generator``, seeded 0 on the model's device when none is passed
        (ROADMAP.md F19). Capacitron's draw is ``eps``, else drawn on the
        host from a generator seeded 0."""
        if self.config.prenet_dropout_at_inference and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.module.inference(x, x_lengths, aux_input=aux_input, max_steps=max_steps,
                                     generator=generator, eps=eps,
                                     style_generator=torch.Generator().manual_seed(0))
