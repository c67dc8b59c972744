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

The DDC coarse decoder, the losses and the gradual-training schedule serve
training and wait for it (ROADMAP.md item 17); GST and Capacitron raise
(item 16).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.tacotron import (
    ConvBNBlock,
    Postnet,
    Tacotron2DecoderCell,
    Tacotron2Encoder,
)
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
    """The width appended to the encoder outputs: the speaker embedding's,
    or the d-vectors', or 0."""
    if config.use_speaker_embedding and config.num_speakers > 1:
        return config.speaker_embedding_dim
    if config.use_d_vector_file:
        return config.d_vector_dim
    return 0


class Tacotron2Module(nn.Module):
    """The Tacotron2 network; ``r_init`` sizes the projection (``config.r``
    when not given), ``config.r`` is the decode's reduction factor."""

    def __init__(self, config: Tacotron2Config, r_init: Optional[int] = None):
        super().__init__()
        if config.use_gst or config.use_capacitron_vae:
            raise NotImplementedError("Tacotron2 with GST or Capacitron is not ported to "
                                      "tts_tpu_torch yet (ROADMAP.md item 16)")
        self.out_channels = config.out_channels
        self.use_speaker_embedding = config.use_speaker_embedding and config.num_speakers > 1
        in_channels = config.encoder_in_features + speaker_channels(config)
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

    def _encode(self, text, text_lengths, aux_input: Optional[Dict] = None):
        """Encoder outputs ``[B, T_in, C]``, with a speaker embedding (from
        ``speaker_ids``) or a d-vector appended to every token."""
        x_mask = sequence_mask(text_lengths, text.shape[1])[:, :, None].float()
        enc = self.encoder(self.embedding(text), x_mask)
        aux_input = aux_input or {}
        vec = None
        if self.use_speaker_embedding and aux_input.get("speaker_ids") is not None:
            vec = self.speaker_embedding(aux_input["speaker_ids"])
        elif aux_input.get("d_vectors") is not None:
            vec = aux_input["d_vectors"]
        if vec is not None:
            enc = torch.cat([enc, vec[:, None, :].expand(-1, enc.shape[1], -1)], dim=-1)
        return enc

    def _attention_inputs(self, enc):
        """The ``inputs_layer`` projection the location-sensitive attention
        reads (Graves and DCA read none)."""
        return self.inputs_layer(enc) if self.decoder_cell.attn_type == "original" else None

    def forward(self, text, text_lengths, mel_specs,
                aux_input: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Teacher-forced decode (reference ``tacotron2.py`` forward): the
        mel is grouped by ``r`` frames and the prenet of each step sees the
        last frame of the previous group (reference
        ``Decoder._update_memory``, ``tacotron2.py:246``)."""
        B, T_in = text.shape
        r, C = self.r, self.out_channels
        enc = self._encode(text, text_lengths, aux_input)
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
                  max_steps: int = 500,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Free-running decode of at most ``max_steps`` steps of ``r``
        frames. Returns ``model_outputs`` and ``decoder_outputs`` ``[B,
        max_steps × r, C]`` (zero after each row's ``mel_lengths`` frames),
        and ``alignments`` ``[B, steps, T_in]`` and ``stop_tokens`` ``[B,
        steps]`` over the steps that ran. ``generator`` draws the prenet's
        dropout where the config keeps it at inference."""
        B, T_in = text.shape
        r, C = self.r, self.out_channels
        enc = self._encode(text, text_lengths, aux_input)
        input_mask = sequence_mask(text_lengths, T_in)
        processed = self._attention_inputs(enc)
        carry = self.decoder_cell.init_carry(B, T_in, enc.shape[-1], enc.device)
        prev = torch.zeros(B, C, device=enc.device)
        finished = torch.zeros(B, dtype=torch.bool, device=enc.device)
        outputs, stops, aligns, active = [], [], [], []
        for step in range(max_steps):
            carry, (out, stop, align) = self.decoder_cell(carry, prev, enc, processed, input_mask,
                                                          generator)
            outputs.append(out)
            stops.append(stop)
            aligns.append(align)
            active.append(~finished)
            finished = finished | (torch.sigmoid(stop) > 0.5)
            prev = out[:, (r - 1) * C:]
            if (step + 1) % STOP_CHECK_EVERY == 0 and bool(finished.all()):
                break
        steps = len(outputs)
        active = torch.stack(active, 1)  # [B, steps]: the step ran before the row's stop
        valid = torch.zeros(B, max_steps * r, 1, device=enc.device)
        valid[:, : steps * r] = active.repeat_interleave(r, dim=1)[:, :, None].float()
        decoder_outputs = torch.zeros(B, max_steps * r, C, device=enc.device)
        decoder_outputs[:, : steps * r] = torch.stack(outputs, 1).reshape(B, steps * r, C)
        decoder_outputs = decoder_outputs * valid
        return {
            "model_outputs": decoder_outputs + self.postnet(decoder_outputs) * valid,
            "decoder_outputs": decoder_outputs,
            "alignments": torch.stack(aligns, 1),
            "stop_tokens": torch.stack(stops, 1),
            "mel_lengths": active.sum(1) * r,
        }


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
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: linear, conv and LSTM
        weights N(0, 1/fan_in), biases 0, norm scales 1 and shifts 0, the
        token embedding N(0, 0.3²) (the JAX package's initialiser)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, (nn.LayerNorm, ConvBNBlock)):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif "bias" in name.rsplit(".", 1)[1]:
                p.zero_()
            elif isinstance(owner, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
        self.module.to(device).requires_grad_(False)
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
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Text ids → mel (:meth:`Tacotron2Module.inference`). Where the
        config keeps the prenet's dropout at inference, its masks come from
        ``generator``, seeded 0 on the model's device when none is passed
        (ROADMAP.md F19)."""
        if self.config.prenet_dropout_at_inference and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.module.inference(x, x_lengths, aux_input=aux_input, max_steps=max_steps,
                                     generator=generator)
