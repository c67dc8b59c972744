"""Tacotron (v1) inference (port of ``tts_tpu/models/tacotron2/tacotron_v1.py``,
reference ``TTS/tts/models/tacotron.py``): ``TacotronModule`` (embedding,
encoder prenet and CBHG, the Tacotron2 decoder cell over mel frames, the
post-CBHG and ``last_linear`` to a linear spectrogram) and the ``Tacotron``
host wrapper. The JAX registry names it ``tacotron``. The teacher-forced
forward and the losses serve training and wait for it (ROADMAP.md item 17).

The network equals the JAX package's, which is not the reference's
(ROADMAP.md F41): it reuses the Tacotron2 decoder cell with its default
settings (location-sensitive attention, softmax, the original prenet), so
the config's ``attention_type``, ``attention_heads``, ``attention_norm``
and ``prenet_type`` are not read; the GST and Capacitron take the JAX
module's widths (GST 256 wide with 4 heads and 10 tokens, Capacitron 128)
and layer norms whatever the config says, and Capacitron summarises the
text at its last (padded) token. No reference checkpoint fits it, so the
model loads only the port's own ``model_torch.pt``; a reference-layout file
raises.

The style comes from ``aux_input["style_mel"]``, as for Tacotron2. The JAX
``Tacotron`` inherits ``Tacotron2.inference``, which passes the module no
``style_mel`` (its module takes the style from an argument of its own), so
through the JAX ``synthesis`` a GST model always gets the zero style and a
Capacitron model always draws from the prior (ROADMAP.md F39).

The decode loop (``model.free_run``), the early exit on the rows' stops and
the reduction factor are Tacotron2's. The post-CBHG runs under the stop mask, on
the frames of the steps that ran: its output at emitted frames does not
depend on the frames after them, so they equal the JAX package's, which
runs it on the whole ``max_steps × r`` budget.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.capacitron import CapacitronVAE
from tts_tpu_torch.layers.tacotron import Prenet, Tacotron2DecoderCell
from tts_tpu_torch.layers.tacotron_v1 import CBHG, GST
from tts_tpu_torch.ops.helpers import sequence_mask

from .config import TacotronConfig
from .model import PORT_WEIGHTS, PROJECTION, Tacotron2, broadcast_concat, free_run

# the JAX TacotronModule's style widths, which its wrapper never sets from the config
GST_HEADS, GST_TOKENS, GST_DIM, CAPACITRON_DIM = 4, 10, 256, 128


class TacotronModule(nn.Module):
    """The Tacotron v1 network; ``r_init`` sizes the projection
    (``config.r`` when not given)."""

    def __init__(self, config: TacotronConfig, r_init: Optional[int] = None):
        super().__init__()
        f = config.cbhg_features
        self.frame_channels = config.decoder_output_dim
        self.embedding = nn.Embedding(config.num_chars, config.embedding_dim)
        self.encoder_prenet = Prenet(config.embedding_dim, (config.embedding_dim, f))
        self.encoder_cbhg = CBHG(f, K=config.cbhg_K, conv_bank_features=f,
                                 conv_projections=(f, f), highway_features=f, gru_features=f)
        in_channels = 2 * f
        if config.use_gst:
            self.gst_layer = GST(config.decoder_output_dim, GST_HEADS, GST_TOKENS, GST_DIM)
            in_channels += GST_DIM
        if config.use_capacitron_vae:
            self.capacitron_vae_layer = CapacitronVAE(config.decoder_output_dim, in_channels,
                                                      CAPACITRON_DIM)
            in_channels += CAPACITRON_DIM
        self.decoder_cell = Tacotron2DecoderCell(
            in_channels=in_channels, frame_channels=config.decoder_output_dim, r=config.r,
            r_init=r_init or config.r, query_dim=config.query_dim,
            decoder_rnn_dim=config.decoder_rnn_dim, prenet_dim=config.prenet_dim,
            attn_dim=config.attn_dim,
            prenet_dropout_at_inference=config.prenet_dropout_at_inference)
        self.inputs_layer = nn.Linear(in_channels, config.attn_dim, bias=False)
        self.post_cbhg = CBHG(config.decoder_output_dim, K=config.post_cbhg_K,
                              conv_bank_features=f,
                              conv_projections=(2 * f, config.decoder_output_dim),
                              highway_features=f, gru_features=f)
        self.last_linear = nn.Linear(2 * f, config.out_channels)

    @property
    def r(self) -> int:
        return self.decoder_cell.r

    def _encode(self, text, text_lengths, style_mel=None, eps=None, generator=None):
        """Encoder outputs ``[B, T_in, C]`` (zero at padded tokens), with the
        GST style vector (zeros without ``style_mel``) and Capacitron's ``z``
        appended to every token."""
        x_mask = sequence_mask(text_lengths, text.shape[1])[:, :, None].float()
        h = self.encoder_prenet(self.embedding(text))
        enc = self.encoder_cbhg(h, x_mask) * x_mask
        if hasattr(self, "gst_layer"):
            enc = broadcast_concat(enc, self.gst_layer(style_mel) if style_mel is not None
                                   else enc.new_zeros(enc.shape[0], GST_DIM))
        if hasattr(self, "capacitron_vae_layer"):
            enc = broadcast_concat(enc, self.capacitron_vae_layer(style_mel, enc, eps=eps,
                                                                  generator=generator))
        return enc

    def inference(self, text, text_lengths, aux_input: Optional[Dict] = None,
                  max_steps: int = 500, generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  style_generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Free-running decode of at most ``max_steps`` steps of ``r`` mel
        frames. Returns ``model_outputs``, the linear spectrogram ``[B,
        max_steps × r, out_channels]``, and ``decoder_outputs``, the mel,
        both zero after each row's ``mel_lengths`` frames, with
        ``alignments`` and ``stop_tokens`` over the steps that ran. The
        style comes from ``aux_input["style_mel"]`` (ROADMAP.md F39);
        ``generator``, ``eps`` and ``style_generator`` are Tacotron2's."""
        enc = self._encode(text, text_lengths, (aux_input or {}).get("style_mel"), eps,
                           style_generator)
        out = free_run(self.decoder_cell, enc, self.inputs_layer(enc),
                       sequence_mask(text_lengths, text.shape[1]), max_steps, generator)
        valid = out.pop("valid")
        linear = self.last_linear(self.post_cbhg(out["decoder_outputs"], valid)) * valid
        pad = (0, 0, 0, max_steps * self.r - valid.shape[1])
        return {**out, "model_outputs": nn.functional.pad(linear, pad),
                "decoder_outputs": nn.functional.pad(out["decoder_outputs"], pad)}


class Tacotron(Tacotron2):
    """Host wrapper around :class:`TacotronModule`: Tacotron2's tokenizer,
    reduction factor, weights and inference, with a linear-spectrogram
    output (Griffin-Lim through ``AudioProcessor.inv_spectrogram``; a mel
    vocoder cannot take it, ROADMAP.md F40)."""

    def __init__(self, config: TacotronConfig):
        self.config = config
        self.r_init = config.r
        self.module = TacotronModule(config)
        self.tokenizer = None

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict), the module built anew for
        the ``r_init`` of the state's projection when it differs."""
        r_init = state[PROJECTION].shape[0] // self.config.decoder_output_dim
        if r_init != self.r_init:
            self.r_init = r_init
            with torch.device("meta"):
                self.module = TacotronModule(self.config, r_init)
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)

    def load_checkpoint(self, config: TacotronConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "Tacotron":
        """Weights from the port's state_dict of :class:`TacotronModule`
        (``model_torch.pt``, or ``{"model": state, "r": r}``); a
        reference-layout checkpoint raises (ROADMAP.md F41)."""
        device = resolve_device(device)
        path = checkpoint_path or os.path.join(checkpoint_dir, PORT_WEIGHTS)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"No model weights at {path} (Tacotron v1 loads "
                                    f"{PORT_WEIGHTS} only)")
        checkpoint = torch.load(path, map_location="cpu", weights_only=True)
        state, r = checkpoint, None
        if isinstance(checkpoint, dict) and "model" in checkpoint:
            state, r = checkpoint["model"], checkpoint.get("r")
        if PROJECTION not in state:
            raise NotImplementedError(
                f"{path} is not a state_dict of tts_tpu_torch's TacotronModule: no converter "
                f"reads a reference Tacotron v1 checkpoint, whose network the JAX package's "
                f"(and so the port's) is not (ROADMAP.md F41)")
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        self.set_r(int(r) if r is not None else self.config.r)
        return self
