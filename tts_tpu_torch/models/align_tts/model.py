"""AlignTTS text → mel inference (port of ``tts_tpu/models/align_tts/model.py:49-163``
and the wrapper ``:196-236``, reference ``TTS/tts/models/align_tts.py``):
token embedding, the encoder (``fftransformer`` or ``residual_conv_bn``
blocks of ``layers.feed_forward``), ``mod_layer`` and the duration
predictor, durations rounded to frames (at least one a token, times
``length_scale``), expansion through the monotonic path
(``generate_path``), positional encoding, the decoder and ``proj``.
``AlignTTS`` is the host wrapper (tokenizer, weights).

The decode runs at a frame budget (``max_frames``): ``y_lengths`` is cut
there, as in the JAX package. The MDN head and its loss serve training and
wait for it (ROADMAP.md item 17): the port builds no ``mdn_*`` layers and
its weight carrier drops the JAX package's. The JAX package has no
reference-layout converter for AlignTTS, so the port loads its own
checkpoint (``model_torch.pt``) and the JAX package's parameters
(``utils.convert.align_tts_from_jax_params``), and nothing more.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.common import DurationPredictor
from tts_tpu_torch.layers.feed_forward import (
    FFTransformerBlock,
    PositionalEncoding,
    ResidualConv1dBNBlock,
)
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
from tts_tpu_torch.text.tokenizer import TTSTokenizer

from .config import AlignTTSArgs, AlignTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of AlignTTSModule


def _make_block(kind: str, channels: int, params: dict) -> nn.Module:
    """The JAX package's ``_make_block`` (``:49-66``): its defaults are 2
    heads, where ForwardTTS's are 1."""
    if kind == "fftransformer":
        return FFTransformerBlock(channels, params.get("num_heads", 2),
                                  params.get("hidden_channels_ffn", 1024),
                                  params.get("num_layers", 6))
    return ResidualConv1dBNBlock(channels, channels, params.get("kernel_size", 4),
                                 tuple(params.get("dilations", [1, 2, 4] * 4 + [1])),
                                 params.get("num_conv_blocks", 2))


class AlignTTSModule(nn.Module):
    """The AlignTTS network, without the training-only MDN head."""

    def __init__(self, args: AlignTTSArgs):
        super().__init__()
        a = self.args = args
        self.emb = nn.Embedding(a.num_chars, a.hidden_channels)
        self.pos_encoder = PositionalEncoding(a.hidden_channels)
        self.encoder = _make_block(a.encoder_type, a.hidden_channels, a.encoder_params)
        self.decoder = _make_block(a.decoder_type, a.hidden_channels, a.decoder_params)
        self.duration_predictor = DurationPredictor(a.hidden_channels, a.hidden_channels_dp, 3)
        self.mod_layer = nn.Linear(a.hidden_channels, a.hidden_channels)
        self.proj = nn.Linear(a.hidden_channels, a.out_channels)

    def durations(self, x, x_lengths):
        """The encoder output ``[B, T_en, C]``, the token mask and the frames
        a token ``[B, T_en]``: ``round((exp(log_dur) - 1) · length_scale)``
        of the predictor on ``mod_layer`` of the encoder, at least 1 for a
        valid token, 0 for padding."""
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].float()
        o_en = self.encoder(self.emb(x) * x_mask, x_mask)
        o_dr_log = self.duration_predictor(self.mod_layer(o_en) * x_mask, x_mask)[..., 0]
        mask = x_mask[..., 0]
        o_dr = torch.round((torch.exp(o_dr_log) - 1) * mask * self.args.length_scale)
        return o_en, x_mask, torch.clamp(o_dr, min=1.0) * mask

    def inference(self, x, x_lengths, aux_input: Optional[Dict] = None,
                  max_frames: int = 1000) -> Dict[str, Any]:
        """Token ids ``[B, T_en]`` → mel ``[B, max_frames, C]`` with the frame
        counts in ``y_lengths`` (cut at ``max_frames``)."""
        o_en, x_mask, o_dr = self.durations(x, x_lengths)
        y_lengths = torch.clamp(o_dr.sum(dim=1), 1, max_frames).long()
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None].float()
        attn = generate_path(o_dr, x_mask * y_mask.transpose(1, 2))
        o_en_ex = self.pos_encoder(torch.einsum("bxy,bxc->byc", attn, o_en), y_mask)
        o_de = self.proj(self.decoder(o_en_ex, y_mask)) * y_mask
        return {"model_outputs": o_de, "alignments": attn.transpose(1, 2), "durations": o_dr,
                "y_lengths": y_lengths, "y_mask": y_mask}


class AlignTTS:
    """Host wrapper: tokenizer and weights around :class:`AlignTTSModule`."""

    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: AlignTTSConfig):
        self.config = config
        self.args = config.model_args
        self.module = AlignTTSModule(self.args)
        self.tokenizer: Optional[TTSTokenizer] = None

    @classmethod
    def init_from_config(cls, config: AlignTTSConfig) -> "AlignTTS":
        """Tokenizer and model for ``config``; the embedding has the
        vocabulary's size when ``model_args.num_chars`` is ``None`` (a
        smaller one raises, ROADMAP.md F7)."""
        tokenizer, config = init_tokenizer(config)
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.emb.weight.device

    @property
    def hop_length(self) -> int:
        return int(self.config.audio.hop_length)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda") -> "AlignTTS":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: norm scales 1 and biases
        0; linear, conv and attention weights N(0, 1/fan_in); the token
        embedding N(0, 1/hidden). The duration predictor's output is a tenth
        of its scale with the bias ``DURATION_BIAS`` of GlowTTS, so that a
        token lasts about 6 frames (LJSpeech's pace)."""
        from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to("cpu")
        for name, p in module.named_parameters():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            fan_in = p[0].numel() if p.dim() > 1 else 1
            if isinstance(owner, nn.LayerNorm):
                p.fill_(0.0 if leaf == "bias" else 1.0)
            elif owner_name == "duration_predictor.proj":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1 / fan_in**0.5
                        if leaf == "weight" else torch.full(p.shape, DURATION_BIAS))
            elif "bias" in leaf:
                p.zero_()
            elif isinstance(owner, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen) * self.args.hidden_channels**-0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
        self.module.to(device).requires_grad_(False)
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra);
        the positional table follows them to their device."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.to(self.device).requires_grad_(False)

    def load_checkpoint(self, config: AlignTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "AlignTTS":
        """Weights from the port's state_dict of :class:`AlignTTSModule`
        (``model_torch.pt`` in ``checkpoint_dir``, or ``checkpoint_path``).
        A reference-layout checkpoint raises: neither package converts
        one (ROADMAP.md item 16)."""
        device = resolve_device(device)
        if checkpoint_path is None:
            checkpoint_path = os.path.join(checkpoint_dir, PORT_WEIGHTS)
            if not os.path.isfile(checkpoint_path):
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS})")
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(self.module.state_dict()):
            raise NotImplementedError("no reference-layout converter for AlignTTS in tts_tpu or "
                                      "tts_tpu_torch (ROADMAP.md item 16): load the port's "
                                      f"{PORT_WEIGHTS}")
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_frames: int = 1000,
                  aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Text ids → mel (:meth:`AlignTTSModule.inference`); the model takes
        no speaker."""
        return self.module.inference(x, x_lengths, max_frames=max_frames)
