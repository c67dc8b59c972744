"""GlowTTS text → mel inference (port of ``tts_tpu/models/glow_tts/model.py``,
reference ``TTS/tts/models/glow_tts.py``): ``GlowTTSEncoder`` (token
embedding, conv prenet, relative-position transformer, mean and log-scale
projections, duration predictor), ``GlowTTSModule.inference`` (durations →
monotonic path → expanded prior → the flow decoder in reverse) and the
``GlowTTS`` host wrapper (tokenizer, weights, noise).

Speakers condition the module as in the JAX package: ``aux_input`` carries
``speaker_ids`` (through ``emb_g`` when ``use_speaker_embedding`` and more
than one speaker) or ``d_vectors``; either is L2-normalised, appended to the
duration predictor's input and fed to every coupling block's WaveNet. The
host wrapper has no speaker manager, as the JAX package's has none.

``inference_noise_scale`` is applied: the prior sample is ``y_mean +
exp(y_log_scale) · ε · scale``, ε drawn from a ``torch.Generator`` (seeded 0
unless the caller passes one) or passed in as ``noise``. The JAX module
applies it only when handed a ``noise_rng``, and neither its host wrapper
nor its ``synthesis`` passes one, so the JAX package always decodes the
mean (ROADMAP.md F18). At scale 0, the default, the two agree.

The decode runs at a frame budget (``max_frames``, a multiple of
``num_squeeze``): the predicted length is cut there, as in the JAX package
(``tts_tpu/models/glow_tts/model.py:234-236``).

Training (``tts_tpu/models/glow_tts/model.py:175-213,259-273,357-360``):
``GlowTTSModule.forward`` crops the mel to a multiple of ``num_squeeze``,
runs the flow decoder in the forward direction with its log-determinant,
scores every (token, frame) pair under the encoder's Gaussians
(``_mas_logp``, two ``torch.matmul`` products, without gradient) and takes
the best monotonic path through them (``ops.mas.maximum_path``, K2 on
CUDA); ``glow_tts_loss`` is the flow's negative log-likelihood plus the
duration MSE; ``GlowTTS.train_step`` is the trainer's generic step's loss.
The encoder's dropouts (the prenet's 0.5, the transformer's, the duration
predictor's ``dropout_p_dp``) and the couplings' (``dropout_p_dec``) act
in training mode. F63, kept as the JAX package has it:
``data_dep_init_steps`` is read by neither package, and ``ActNorm``
starts at the identity; the trainer's weights keep the JAX package's zero
leaves at zero (``init_params`` with ``discriminator``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.common import (
    ConvLayerNormBlock,
    DurationPredictor,
    use_dropout_generator,
)
from tts_tpu_torch.layers.glow import ActNorm, GlowDecoder, InvConvNear
from tts_tpu_torch.layers.transformer import RelativePositionTransformer
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
from tts_tpu_torch.ops.mas import maximum_path
from tts_tpu_torch.text.tokenizer import TTSTokenizer

from .config import GlowTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of GlowTTSModule
REFERENCE_WEIGHTS = ("model_file.pth", "model.pth")  # reference-layout (coqui) checkpoints

# the output bias of the duration predictor that init_params sets: a token
# then lasts exp(bias) - 1 = 5.5 frames before the ceiling, about LJSpeech's
# pace of 14 phonemes a second at 86 frames a second
DURATION_BIAS = math.log(6.5)


def cond_channels(config: GlowTTSConfig) -> int:
    """The width of the speaker vector: ``hidden_channels_enc`` with a
    speaker embedding (``emb_g``), else ``c_in_channels`` (d-vectors)."""
    if config.use_speaker_embedding and config.num_speakers > 1:
        return config.hidden_channels_enc
    return config.c_in_channels


class GlowTTSEncoder(nn.Module):
    """Token ids → ``(mean, log_scale, log_durations, x_mask)``, all
    time-major; the duration predictor sees the encoder's output, detached,
    with the speaker vector appended to every frame."""

    def __init__(self, config: GlowTTSConfig, num_chars: int, g_channels: int = 0):
        super().__init__()
        p = config.encoder_params or {}
        hidden = config.hidden_channels_enc
        self.hidden_channels = hidden
        self.mean_only = config.mean_only
        self.emb = nn.Embedding(num_chars, hidden)
        if config.use_encoder_prenet:
            self.prenet = ConvLayerNormBlock(hidden, hidden, hidden, kernel_size=5, num_layers=3,
                                             dropout_p=0.5)
        self.encoder = RelativePositionTransformer(
            hidden, p.get("hidden_channels_ffn", 768), p.get("num_heads", 2),
            p.get("num_layers", 6), p.get("kernel_size", 3), p.get("rel_attn_window_size", 4),
            p.get("dropout_p", 0.1))
        self.proj_m = nn.Linear(hidden, config.out_channels)
        if not config.mean_only:
            self.proj_s = nn.Linear(hidden, config.out_channels)
        self.duration_predictor = DurationPredictor(hidden + g_channels,
                                                    config.hidden_channels_dp, 3,
                                                    dropout_p=config.dropout_p_dp)

    def forward(self, x, x_lengths, g: Optional[torch.Tensor] = None):
        h = self.emb(x) * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(h.dtype)
        if hasattr(self, "prenet"):
            h = self.prenet(h, x_mask)
        h = self.encoder(h, x_mask)
        h_dp = h.detach()
        if g is not None:
            h_dp = torch.cat([h_dp, g[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
        o_mean = self.proj_m(h) * x_mask
        o_log_scale = torch.zeros_like(o_mean) if self.mean_only else self.proj_s(h) * x_mask
        o_dur_log = self.duration_predictor(h_dp, x_mask)
        return o_mean, o_log_scale, o_dur_log, x_mask


class GlowTTSModule(nn.Module):
    """The GlowTTS network (the JAX module's ``enc`` and ``dec``, and
    ``emb_g`` for learned speakers)."""

    def __init__(self, config: GlowTTSConfig, num_chars: int):
        super().__init__()
        self.num_squeeze = config.num_squeeze
        self.length_scale = config.length_scale
        self.inference_noise_scale = config.inference_noise_scale
        self.use_speaker_embedding = config.use_speaker_embedding
        g_channels = cond_channels(config)
        self.enc = GlowTTSEncoder(config, num_chars, g_channels)
        self.dec = GlowDecoder(
            config.out_channels, config.hidden_channels_dec, config.kernel_size_dec,
            config.dilation_rate, config.num_flow_blocks_dec, config.num_block_layers,
            config.num_splits, config.num_squeeze, config.sigmoid_scale, g_channels,
            config.dropout_p_dec)
        if config.use_speaker_embedding and config.num_speakers > 1:
            self.emb_g = nn.Embedding(config.num_speakers, config.hidden_channels_enc)

    def _speaker_vec(self, aux_input: Optional[Dict]) -> Optional[torch.Tensor]:
        """The L2-normalised speaker vector from ids or d-vectors, or
        ``None``."""
        if aux_input is None:
            return None
        d_vectors = aux_input.get("d_vectors")
        speaker_ids = aux_input.get("speaker_ids")
        if speaker_ids is not None and self.use_speaker_embedding:
            g = self.emb_g(speaker_ids)
        elif d_vectors is not None:
            g = d_vectors
        else:
            return None
        return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)

    @staticmethod
    def compute_outputs(attn, o_mean, o_log_scale, x_mask):
        """Token statistics expanded to frames through the alignment."""
        y_mean = torch.einsum("bxy,bxd->byd", attn, o_mean)
        y_log_scale = torch.einsum("bxy,bxd->byd", attn, o_log_scale)
        o_attn_dur = torch.log1p(torch.sum(attn, dim=-1))[:, :, None] * x_mask
        return y_mean, y_log_scale, o_attn_dur

    @staticmethod
    @torch.no_grad()
    def _mas_logp(z, o_mean, o_log_scale):
        """The log-likelihood of every frame of ``z`` under every token's
        Gaussian, ``[B, T_en, T_de]``, without gradient (reference
        ``glow_tts.py:237-243``): two products and two row terms."""
        o_scale = torch.exp(-2.0 * o_log_scale)
        logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - o_log_scale, dim=-1)[:, :, None]
        logp2 = torch.matmul(o_scale, (-0.5 * z**2).transpose(1, 2))
        logp3 = torch.matmul(o_mean * o_scale, z.transpose(1, 2))
        logp4 = torch.sum(-0.5 * (o_mean**2) * o_scale, dim=-1)[:, :, None]
        return logp1 + logp2 + logp3 + logp4

    def forward(self, x, x_lengths, y, y_lengths, aux_input=None) -> Dict[str, Any]:
        """The training pass (reference ``glow_tts.py:192``): token ids ``[B,
        T_en]`` and the mel ``y [B, T_de, C]`` → the flow's latents, its
        log-determinant, the aligned prior and the durations."""
        g = self._speaker_vec(aux_input)
        o_mean, o_log_scale, o_dur_log, x_mask = self.enc(x, x_lengths, g=g)
        y_max = (y.shape[1] // self.num_squeeze) * self.num_squeeze
        y = y[:, :y_max]
        y_lengths = (y_lengths // self.num_squeeze) * self.num_squeeze
        y_mask = sequence_mask(y_lengths, y_max)[:, :, None].to(x_mask.dtype)
        z, logdet, y_mask = self.dec(y * y_mask, y_mask, g=g, reverse=False)
        attn_mask = x_mask * y_mask.transpose(1, 2)
        attn = maximum_path(self._mas_logp(z, o_mean, o_log_scale), attn_mask)
        y_mean, y_log_scale, o_attn_dur = self.compute_outputs(attn, o_mean, o_log_scale, x_mask)
        return {"z": z, "logdet": logdet, "y_mean": y_mean, "y_log_scale": y_log_scale,
                "alignments": attn.transpose(1, 2), "durations_log": o_dur_log,
                "total_durations_log": o_attn_dur, "y_lengths": y_lengths, "y_mask": y_mask,
                "x_mask": x_mask}

    def encode(self, x, x_lengths, aux_input=None, max_frames: int = 1000):
        """Encoder, durations and path: everything before the prior sample."""
        g = self._speaker_vec(aux_input)
        o_mean, o_log_scale, o_dur_log, x_mask = self.enc(x, x_lengths, g=g)
        w = (torch.exp(o_dur_log) - 1.0) * x_mask * self.length_scale
        w_ceil = torch.clamp(torch.ceil(w), min=1.0) * x_mask
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).long()
        y_lengths = torch.clamp((y_lengths // self.num_squeeze) * self.num_squeeze,
                                max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None].to(x_mask.dtype)
        attn_mask = x_mask * y_mask.transpose(1, 2)
        attn = generate_path(w_ceil[:, :, 0], attn_mask)
        y_mean, y_log_scale, o_attn_dur = self.compute_outputs(attn, o_mean, o_log_scale, x_mask)
        return {"g": g, "attn": attn, "y_mean": y_mean, "y_log_scale": y_log_scale,
                "durations_log": o_dur_log, "total_durations_log": o_attn_dur,
                "y_lengths": y_lengths, "y_mask": y_mask}

    def inference(self, x, x_lengths, aux_input=None, max_frames: int = 1000,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Text ids → mel ``[B, max_frames, C]`` with the frame counts in
        ``y_lengths``. ``noise`` (ε, ``[B, max_frames, C]``) is scaled by
        ``inference_noise_scale``; without it, or at scale 0, the decoder
        starts from the mean."""
        e = self.encode(x, x_lengths, aux_input, max_frames)
        y_mask = e["y_mask"]
        if noise is not None and self.inference_noise_scale > 0:
            z = (e["y_mean"] + torch.exp(e["y_log_scale"]) * noise * self.inference_noise_scale)
            z = z * y_mask
        else:
            z = e["y_mean"] * y_mask
        y, _, y_mask_out = self.dec(z, y_mask, g=e["g"], reverse=True)
        return {
            "model_outputs": y,
            "alignments": e["attn"].transpose(1, 2),
            "y_mean": e["y_mean"],
            "y_log_scale": e["y_log_scale"],
            "durations_log": e["durations_log"],
            "total_durations_log": e["total_durations_log"],
            "y_lengths": e["y_lengths"],
            "y_mask": y_mask_out,
        }


def glow_tts_loss(outputs: Dict[str, torch.Tensor], x_lengths,
                  y_lengths) -> Dict[str, torch.Tensor]:
    """The flow's negative log-likelihood a frame and channel plus the
    duration MSE a token (reference ``losses.py:508``)."""
    z, means, scales = outputs["z"], outputs["y_mean"], outputs["y_log_scale"]
    pz = torch.sum(scales) + 0.5 * torch.sum(torch.exp(-2 * scales) * (z - means) ** 2)
    log_mle = 0.5 * math.log(2 * math.pi) + (pz - torch.sum(outputs["logdet"])) / (
        torch.sum(y_lengths) * z.shape[2])
    loss_dur = torch.sum((outputs["durations_log"] - outputs["total_durations_log"]) ** 2
                         ) / torch.sum(x_lengths)
    return {"loss": log_mle + loss_dur, "log_mle": log_mle, "loss_dur": loss_dur}


class GlowTTS:
    """Host wrapper: tokenizer, weights and noise around :class:`GlowTTSModule`."""

    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: GlowTTSConfig):
        self.config = config
        self.module = GlowTTSModule(config, config.num_chars).eval()  # dropouts: training alone
        self.tokenizer: Optional[TTSTokenizer] = None
        self.initialized = False  # the trainer draws weights from config.seed until loaded

    @classmethod
    def init_from_config(cls, config: GlowTTSConfig) -> "GlowTTS":
        """Tokenizer and model for ``config``. The embedding has the
        vocabulary's size when ``num_chars`` is ``None``; a smaller
        ``num_chars`` raises (ROADMAP.md F7)."""
        tokenizer, config = init_tokenizer(config)
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.enc.emb.weight.device

    @property
    def hop_length(self) -> int:
        return int(self.config.audio.hop_length)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda",
                    discriminator: bool = False) -> "GlowTTS":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``. Norm scales are 1 and
        biases 0; linear and conv weights N(0, 1/fan_in); the token
        embedding N(0, 1/hidden) and the relative-position tables N(0, 1/head
        width); each ``InvConvNear`` an orthogonal matrix. The leaves that
        the JAX package starts at zero (the prenet's ``proj``, each
        coupling's ``end``, ``ActNorm``'s ``logs`` and ``bias``) are drawn
        at a tenth of those scales, so that the flows and WaveNets do work.
        The duration predictor's output is a tenth of its scale with bias
        :data:`DURATION_BIAS`, so that a token lasts about 6 frames.
        ``discriminator`` is the trainer's call (weights to train; there is
        no discriminator): the zero leaves then stay zero, as the JAX
        trainer's ``init`` gives them, so that every flow starts as the
        identity (F63)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")

        def normal(shape, std):
            return torch.randn(shape, generator=gen) * std

        for name, p in module.named_parameters():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            fan_in = p[0].numel() if p.dim() > 1 else 1
            zero_init = isinstance(owner, ActNorm) or owner_name.endswith((".end", "prenet.proj"))
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif isinstance(owner, InvConvNear):
                p.copy_(torch.linalg.qr(normal(p.shape, 1.0))[0])
            elif owner_name.endswith("duration_predictor.proj"):
                p.copy_(normal(p.shape, 0.1 / fan_in**0.5) if leaf == "weight"
                        else torch.full(p.shape, DURATION_BIAS))
            elif zero_init:
                p.copy_(normal(p.shape, 0.1 / fan_in**0.5) * (not discriminator))
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, nn.Embedding):
                p.copy_(normal(p.shape, self.config.hidden_channels_enc**-0.5))
            elif leaf in ("emb_rel_k", "emb_rel_v"):
                p.copy_(normal(p.shape, p.shape[-1] ** -0.5))
            else:
                p.copy_(normal(p.shape, fan_in**-0.5))
        self.module.to(device).requires_grad_(False)
        self.initialized = True
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)
        self.initialized = True

    def load_checkpoint(self, config: GlowTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "GlowTTS":
        """Weights from a file: the port's state_dict of
        :class:`GlowTTSModule` (``model_torch.pt``) or a reference-layout
        checkpoint (``model_file.pth`` or ``model.pth``, weight norm folded
        and converted). ``checkpoint_dir`` looks for those names in turn."""
        device = resolve_device(device)
        if checkpoint_path is None:
            for name in (PORT_WEIGHTS,) + REFERENCE_WEIGHTS:
                if os.path.isfile(os.path.join(checkpoint_dir, name)):
                    checkpoint_path = os.path.join(checkpoint_dir, name)
                    break
            else:
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS} or one of {REFERENCE_WEIGHTS})")
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(self.module.state_dict()):
            from tts_tpu_torch.utils.convert import load_reference_glow_tts

            state = load_reference_glow_tts(state, self.config)
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_frames: int = 1000, aux_input: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Text ids → mel (:meth:`GlowTTSModule.inference`). With
        ``inference_noise_scale`` > 0 the prior noise is ``noise`` or, when
        none is passed, drawn from ``generator`` (seeded 0 by default) on the
        model's device (ROADMAP.md F18)."""
        if self.config.inference_noise_scale > 0 and noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            noise = torch.randn((x.shape[0], max_frames, self.config.out_channels),
                                generator=generator, device=self.device)
        return self.module.inference(x, x_lengths, aux_input=aux_input, max_frames=max_frames,
                                     noise=noise)

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   train: bool = True):
        """``(loss, metrics)`` of the training pass on ``batch``: the loss,
        ``log_mle`` and ``loss_dur`` of :func:`glow_tts_loss` and the outputs
        under ``"outputs"``. With ``train`` the dropouts draw from
        ``generator``; without it the module runs in eval mode."""
        module = self.module
        module.train(train)
        use_dropout_generator(module, generator if train else None)
        try:
            outputs = module(batch["text_input"], batch["text_lengths"], batch["mel_input"],
                             batch["mel_lengths"],
                             aux_input={"d_vectors": batch.get("d_vectors"),
                                        "speaker_ids": batch.get("speaker_ids")})
        finally:
            use_dropout_generator(module, None)
        losses = glow_tts_loss(outputs, batch["text_lengths"], outputs["y_lengths"])
        return losses["loss"], {**losses, "outputs": outputs}
