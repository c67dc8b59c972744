"""VITS text → waveform inference (port of ``tts_tpu/models/vits/model.py``):
``VitsModule`` (the generator: text encoder, duration predictor, coupling
flow, HiFiGAN decoder; the posterior encoder is built so weights load
strictly) and the ``Vits`` host wrapper (tokenizer, weights, noise).

The port runs VITS inference as the JAX package does: one utterance per
row (``inference``) or many packed into a few rows (``inference_packed``),
for one speaker or many (a learned speaker embedding ``emb_g`` or
d-vectors) and one language or many (``emb_l``): ``aux_input`` carries
``speaker_ids``, ``d_vectors`` and ``language_ids`` per row. The waveform
decoder is HiFiGAN or, with ``decoder_type="istft"``, the iSTFT head
(``vocoder/models/istft_hifigan.py``). With ``encoder_sample_rate`` the
encoders and flow run at that lower rate and the latent is linearly
upsampled to the output rate (``interpolate_z``) or the decoder's own
upsampling carries the factor. Neither variant takes the packed decode
(ROADMAP.md F2): ``inference_packed`` raises on both.

``voice_conversion`` (speaker ids or d-vectors) runs the posterior encoder
and the flow forward with the source speaker, the flow back with the target
and the decoder, upsampling the latent as ``inference`` does, where the
reference does not (the JAX package's named divergence).

Training (port of ``tts_tpu/models/vits/model.py:149-245`` and the losses
``:449-484``): ``VitsModule.forward`` is the training forward (posterior,
flow, MAS through K2, ``ops/mas.py``, the duration loss, the prior expanded
over the alignment, a random segment decoded), ``Vits.discriminator`` the
multi-period and scale discriminator, and ``Vits.make_train_step`` the GAN
step of ``models/vits/train.py``. Like the JAX package, the training
forward feeds the duration predictor the prior means ``m_p``, where
inference feeds it the encoder's output (ROADMAP.md F12). It trains one
speaker or many (ids or d-vectors) and one language or many, conditioned
where the JAX training forward conditions. ``Vits.format_batch`` and
``Vits.format_batch_on_device`` map the data pipeline's batch to the step's
keys (the trainer, ``trainer/trainer.py``); the posterior encoder reads the
linear magnitude spectrogram of the waveform, as in the reference, where the
JAX package feeds decibels (ROADMAP.md F54).

D-vectors are L2-normalised before they condition anything, in inference
and in voice conversion, as the reference VITS does; the JAX package feeds
them as they are, which differs for a speaker's mean d-vector or one
averaged over several clips, neither of unit length (ROADMAP.md F26).

``Vits.init_from_config`` attaches the speaker and language managers
(``utils/managers.py``), reading their fields from the config's top level or
from ``model_args``, whichever sets them; the JAX package reads the top
level only, and so builds no manager for the repo's multi-speaker recipes
(ROADMAP.md F11).

Noise: each ``inference``/``inference_packed``/``infer_durations`` call
draws from a ``torch.Generator`` on the model's device, seeded 0 unless the
caller passes one, as the JAX package draws from ``PRNGKey(0)`` by default.
All three make the same first draw, so a durations pass and the decode
after it agree, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
import os
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.common import DurationPredictor
from tts_tpu_torch.ops.helpers import generate_path, rand_segments, sequence_mask
from tts_tpu_torch.ops.mas import maximum_path
from tts_tpu_torch.text.tokenizer import TTSTokenizer
from tts_tpu_torch.utils.managers import init_speaker_manager
from tts_tpu_torch.vocoder.models.hifigan_generator import HifiganGenerator
from tts_tpu_torch.vocoder.models.istft_hifigan import IstftHifiganGenerator

from . import modules
from .config import VitsArgs, VitsConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of VitsModule
REFERENCE_WEIGHTS = "model.pth"  # a reference-layout (coqui) checkpoint

DECODER_TYPES = ("hifigan", "istft")


def normalize_d_vectors(d: torch.Tensor) -> torch.Tensor:
    """Each d-vector over its L2 norm (at least 1e-12), as the reference's
    ``F.normalize`` in ``_set_cond_input`` and ``voice_conversion``; neither
    of the JAX package's paths normalises (ROADMAP.md F26)."""
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def check_supported(config: VitsConfig) -> None:
    """Raise on a decoder type the port does not know (the JAX package
    builds HiFiGAN for any name but ``istft``)."""
    if config.model_args.decoder_type not in DECODER_TYPES:
        raise ValueError(f"VITS decoder_type={config.model_args.decoder_type!r}: "
                         f"one of {DECODER_TYPES}")


def interpolate_factor(config: VitsConfig) -> float:
    """``audio.sample_rate / encoder_sample_rate`` (1.0 without an encoder
    rate), with the JAX package's two checks (``tts_tpu/models/vits/model.py:494-522``):
    the rates divide, and the decoder's upsampling covers ``hop_length`` at
    the output rate (times the factor where the latent is not interpolated)."""
    a = config.model_args
    if not a.encoder_sample_rate:
        return 1.0
    sr, enc_sr = config.audio.sample_rate, a.encoder_sample_rate
    if sr % enc_sr != 0:
        raise ValueError(f"audio.sample_rate ({sr}) must be an integer multiple of "
                         f"encoder_sample_rate ({enc_sr})")
    factor = sr / enc_sr
    rates = int(np.prod(a.upsample_rates_decoder))
    if a.decoder_type == "istft":
        rates *= int(a.istft_hop_decoder) * int(a.istft_subbands_decoder)
    need = config.audio.hop_length if a.interpolate_z else config.audio.hop_length * int(factor)
    if rates != need:
        raise ValueError(f"decoder upsampling {rates} != required {need} (hop "
                         f"{config.audio.hop_length}, interpolate_z={a.interpolate_z}, "
                         f"factor {factor})")
    return factor


def supports_packed_decode(config: VitsConfig) -> bool:
    """Whether ``config``'s model may decode sequence-packed rows: not with
    the ``istft`` decoder, which masks no conv, and not where the latent is
    interpolated to the output rate (``encoder_sample_rate`` with
    ``interpolate_z``), which blurs the segments' edges into the gaps. The
    JAX package checks only the first (ROADMAP.md F2)."""
    a = config.model_args
    interpolates = (bool(a.encoder_sample_rate) and a.interpolate_z
                    and config.audio.sample_rate != a.encoder_sample_rate)
    return a.decoder_type != "istft" and not interpolates


class VitsModule(nn.Module):
    """The VITS generator (everything except the discriminator). With
    speakers, the speaker vector ``g`` (``emb_g`` of the ids, or the
    d-vectors) conditions the posterior encoder, the flow, the decoder and,
    under ``condition_dp_on_speaker``, the duration predictor; with
    languages, ``emb_l`` of the ids joins the text encoder's input and
    conditions the stochastic duration predictor."""

    def __init__(self, args: VitsArgs, interpolate_factor: float = 1.0):
        super().__init__()
        self.args = args
        # the latent's upsampling to the output rate (encoder_sample_rate)
        self.interpolate_factor = interpolate_factor
        if args.use_d_vector_file and not args.d_vector_dim:
            raise ValueError("use_d_vector_file needs d_vector_dim, the d-vectors' width")
        if args.use_language_embedding and not args.num_languages:
            raise ValueError("use_language_embedding needs num_languages > 0: give a "
                             "language_ids_file (or language_ids_file_path)")
        speaker_dim = (args.d_vector_dim if args.use_d_vector_file else
                       args.speaker_embedding_channels if args.use_speaker_embedding else 0)
        lang_dim = args.embedded_language_dim if args.use_language_embedding else 0
        dp_cond = speaker_dim if args.condition_dp_on_speaker else 0
        if args.use_speaker_embedding and args.num_speakers > 0:
            self.emb_g = nn.Embedding(args.num_speakers, args.speaker_embedding_channels)
        if lang_dim:
            self.emb_l = nn.Embedding(args.num_languages, lang_dim)
        self.text_encoder = modules.TextEncoder(
            n_vocab=args.num_chars,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            hidden_channels_ffn=args.hidden_channels_ffn_text_encoder,
            num_heads=args.num_heads_text_encoder,
            num_layers=args.num_layers_text_encoder,
            kernel_size=args.kernel_size_text_encoder,
            language_emb_dim=lang_dim,
            dropout_p=args.dropout_p_text_encoder,
        )
        self.posterior_encoder = modules.PosteriorEncoder(
            in_channels=args.out_channels,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_posterior_encoder,
            dilation_rate=args.dilation_rate_posterior_encoder,
            num_layers=args.num_layers_posterior_encoder,
            cond_channels=speaker_dim,
        )
        self.flow = modules.ResidualCouplingBlocks(
            channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_flow,
            dilation_rate=args.dilation_rate_flow,
            num_layers=args.num_layers_flow,
            cond_channels=speaker_dim,
        )
        # the duration predictors read the text encoder's output (ROADMAP.md F12)
        if args.use_sdp:
            self.duration_predictor = modules.StochasticDurationPredictor(
                in_channels=args.hidden_channels + lang_dim, hidden_channels=192,
                kernel_size=3, num_flows=4, cond_channels=dp_cond, language_emb_dim=lang_dim,
                dropout_p=args.dropout_p_duration_predictor,
            )
        else:
            self.duration_predictor = DurationPredictor(
                in_channels=args.hidden_channels + lang_dim, hidden_channels=256,
                kernel_size=3, cond_channels=dp_cond,
                dropout_p=args.dropout_p_duration_predictor,
            )
        decoder = dict(
            in_channels=args.hidden_channels,
            resblock_type=args.resblock_type_decoder,
            resblock_dilation_sizes=[tuple(d) for d in args.resblock_dilation_sizes_decoder],
            resblock_kernel_sizes=tuple(args.resblock_kernel_sizes_decoder),
            upsample_kernel_sizes=tuple(args.upsample_kernel_sizes_decoder),
            upsample_initial_channel=args.upsample_initial_channel_decoder,
            upsample_factors=tuple(args.upsample_rates_decoder),
            cond_channels=speaker_dim,
        )
        if args.decoder_type == "istft":
            self.waveform_decoder = IstftHifiganGenerator(
                istft_n_fft=args.istft_n_fft_decoder, istft_hop=args.istft_hop_decoder,
                subbands=args.istft_subbands_decoder, **decoder)
        else:
            self.waveform_decoder = HifiganGenerator(out_channels=1, conv_post_bias=False,
                                                     **decoder)

    def _cond_vectors(self, aux_input: Optional[Dict]):
        """``(g [B, C_g] or None, lang [B, C_l] or None)`` from ``aux_input``'s
        ``d_vectors`` (d-vector models; L2-normalised, ROADMAP.md F26), else
        ``speaker_ids``, and ``language_ids``, each taken only by a model
        built for it."""
        a = self.args
        g = lang = None
        if aux_input:
            if aux_input.get("d_vectors") is not None and a.use_d_vector_file:
                g = normalize_d_vectors(aux_input["d_vectors"])
            elif aux_input.get("speaker_ids") is not None and a.use_speaker_embedding:
                g = self.emb_g(aux_input["speaker_ids"])
            if aux_input.get("language_ids") is not None and a.use_language_embedding:
                lang = self.emb_l(aux_input["language_ids"])
        return g, lang

    def _upsample_z(self, z: torch.Tensor) -> torch.Tensor:
        """The latent ``[B, T, C]`` linearly resized to ``T * factor`` frames
        with half-pixel centres (``align_corners=False``, which is
        ``jax.image.resize``'s linear resize), where ``interpolate_z`` is on
        and the encoder rate is below the output rate; else unchanged (port
        of ``tts_tpu/models/vits/model.py:160-171``)."""
        f = int(round(self.interpolate_factor))
        if f == 1 or not self.args.interpolate_z:
            return z
        z = F.interpolate(z.transpose(1, 2), size=z.shape[1] * f, mode="linear",
                          align_corners=False)
        return z.transpose(1, 2)

    def _forward_mas(self, z_p, m_p, logs_p, x_mask, y_mask) -> torch.Tensor:
        """The alignment ``[B, T_x, T_y]``: MAS (K2) over the log-likelihood of
        the flow latents under each token's prior, without gradient (port of
        ``tts_tpu/models/vits/model.py:149-158``; the two einsums are matmuls)."""
        attn_mask = x_mask * y_mask.transpose(1, 2)
        with torch.no_grad():
            o_scale = torch.exp(-2.0 * logs_p)
            logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=-1)[:, :, None]
            logp2 = torch.matmul(o_scale, (-0.5 * z_p**2).transpose(1, 2))
            logp3 = torch.matmul(m_p * o_scale, z_p.transpose(1, 2))
            logp4 = torch.sum(-0.5 * (m_p**2) * o_scale, dim=-1)[:, :, None]
            logp = logp1 + logp2 + logp3 + logp4
            return maximum_path(logp, attn_mask)

    def _dp_input(self, m_p: torch.Tensor) -> torch.Tensor:
        """The training forward's duration-predictor input: the prior means,
        zero-padded to the predictor's input width. A language embedding
        widens the text encoder's output, which inference feeds the
        predictor, by its own channels; the means are ``hidden_channels``
        wide (ROADMAP.md F12). The means fill the first inputs and the
        language's channels read zero, which computes what the JAX
        package's predictor, sized from the means by its training forward,
        computes."""
        a = self.args
        extra = a.embedded_language_dim if a.use_language_embedding else 0
        return F.pad(m_p, (0, extra)) if extra else m_p

    def forward(self, x, x_lengths, y, y_lengths, generator: torch.Generator,
                aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """The training forward (reference ``vits.py:961``; port of
        ``tts_tpu/models/vits/model.py:174-245``): ids ``[B, T_x]``, the linear
        spectrogram ``y [B, T_y, C_spec]`` and their lengths → the decoded
        segment ``model_outputs [B, spec_segment_size * hop, 1]``, its start
        frames ``slice_ids``, the alignment, the prior expanded over it, the
        posterior and flow latents and ``loss_duration``. Draws, all from
        ``generator``: the posterior's noise and the duration posterior's
        (``modules.normal``), the segment starts (``ops.helpers.uniform``)
        and, in training mode, the dropout masks. The duration predictor
        reads the prior means ``m_p`` (detached under ``detach_dp_input``),
        as the JAX package's training does (ROADMAP.md F12).

        ``aux_input`` (``speaker_ids``, ``d_vectors``, ``language_ids`` per
        row) conditions as the JAX training forward does
        (``tts_tpu/models/vits/model.py:174-245``): the language embedding
        joins the text encoder's input and conditions the stochastic
        duration predictor; the speaker vector ``g`` conditions the
        posterior encoder, the flow, the decoder and, under
        ``condition_dp_on_speaker``, the duration predictor, detached there
        under ``detach_dp_input``."""
        a = self.args
        g, lang = self._cond_vectors(aux_input)
        _, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, lang)
        z, m_q, logs_q, y_mask = self.posterior_encoder(y, y_lengths, generator, g=g)
        z_p = self.flow(z, y_mask, g=g, reverse=False)
        attn = self._forward_mas(z_p, m_p, logs_p, x_mask, y_mask)
        # in fp32 (or wider): bf16 under autocast holds no integer above 256
        attn_durations = torch.sum(attn.to(torch.promote_types(m_p.dtype, torch.float32)),
                                   dim=-1, keepdim=True)  # [B, T_x, 1]
        x_dp = self._dp_input(m_p.detach() if a.detach_dp_input else m_p)
        dp_g = None
        if g is not None and a.condition_dp_on_speaker:
            dp_g = g.detach() if a.detach_dp_input else g
        if a.use_sdp:
            nll = self.duration_predictor.nll(x_dp, x_mask, attn_durations, generator, g=dp_g,
                                              lang_emb=lang)
            loss_duration = torch.sum(nll) / torch.sum(x_mask)
        else:
            attn_log_durations = torch.log(attn_durations + 1e-6) * x_mask
            log_durations = self.duration_predictor(x_dp, x_mask, g=dp_g)
            loss_duration = torch.sum((log_durations - attn_log_durations) ** 2) / torch.sum(
                x_mask)
        attn_t = attn.transpose(1, 2).to(m_p.dtype)
        m_p_e = torch.matmul(attn_t, m_p)  # [B, T_y, C]
        logs_p_e = torch.matmul(attn_t, logs_p)
        z_slice, slice_ids = rand_segments(generator, z, y_lengths, a.spec_segment_size,
                                           let_short_samples=True, pad_short=True)
        o = self.waveform_decoder(self._upsample_z(z_slice), g=g)
        return {
            "model_outputs": o,
            "alignments": attn.transpose(1, 2),
            "m_p": m_p_e,
            "logs_p": logs_p_e,
            "z": z,
            "z_p": z_p,
            "m_q": m_q,
            "logs_q": logs_q,
            "durations": attn_durations,
            "loss_duration": loss_duration,
            "slice_ids": slice_ids,
            "x_mask": x_mask,
            "y_mask": y_mask,
        }

    def _durations(self, x, x_lengths, generator, g=None, lang=None):
        """Text encoder and duration predictor: ``(w_ceil [B, T_x, 1], m_p,
        logs_p, x_mask)``. With the stochastic predictor this makes the
        call's first noise draw."""
        a = self.args
        x_hid, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, lang)
        dp_g = g if a.condition_dp_on_speaker else None
        if a.use_sdp:
            logw = self.duration_predictor(x_hid, x_mask, generator,
                                           noise_scale=a.inference_noise_scale_dp, g=dp_g,
                                           lang_emb=lang)
        else:
            logw = self.duration_predictor(x_hid, x_mask, g=dp_g)
        w = torch.exp(logw) * x_mask * a.length_scale
        return torch.ceil(w) * x_mask, m_p, logs_p, x_mask

    @torch.no_grad()
    def durations(self, x, x_lengths, generator: torch.Generator,
                  aux_input: Optional[Dict] = None) -> torch.Tensor:
        """Each token's frame count ``w_ceil [B, T_x, 1]``, as the decode
        that starts from the same generator state would take it."""
        return self._durations(x, x_lengths, generator, *self._cond_vectors(aux_input))[0]

    @torch.no_grad()
    def infer_durations(self, x, x_lengths, generator: torch.Generator,
                        aux_input: Optional[Dict] = None) -> torch.Tensor:
        """Predicted output frame counts ``[B]`` (int32, at least 1)."""
        w_ceil = self.durations(x, x_lengths, generator, aux_input)
        return torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

    @torch.no_grad()
    def inference(self, x, x_lengths, generator: torch.Generator, max_frames: int = 1000,
                  aux_input: Optional[Dict] = None,
                  durations: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Text ids ``[B, T_x]`` → waveform ``[B, max_frames * hop, 1]``. The
        whole frame budget is decoded, as in the JAX package: frames past
        ``y_lengths`` are zero going into the decoder, but its convolutions
        reach over the boundary. ``durations`` (``w_ceil [B, T_x, 1]``, from
        :meth:`durations`) are taken in place of the duration predictor's,
        which then draws nothing: the latent's noise is the generator's
        first draw."""
        a = self.args
        g, lang = self._cond_vectors(aux_input)
        if durations is None:
            w_ceil, m_p, logs_p, x_mask = self._durations(x, x_lengths, generator, g, lang)
        else:
            _, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, lang)
            w_ceil = durations.to(x_mask.dtype) * x_mask
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), 1, max_frames).to(torch.int32)
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None].to(x_mask.dtype)
        attn_mask = x_mask * y_mask.transpose(1, 2)
        attn = generate_path(w_ceil[:, :, 0], attn_mask)  # [B, T_x, T_y]

        m_p_e = torch.bmm(attn.transpose(1, 2), m_p)
        logs_p_e = torch.bmm(attn.transpose(1, 2), logs_p)
        noise = modules.normal(m_p_e.shape, generator)
        z_p = m_p_e + noise * torch.exp(logs_p_e) * a.inference_noise_scale
        z = self.flow(z_p * y_mask, y_mask, g=g)
        o = self.waveform_decoder(self._upsample_z(z * y_mask), g=g)
        return {
            "model_outputs": o,
            "alignments": attn.transpose(1, 2),
            "durations": w_ceil,
            "y_lengths": y_lengths,
            "y_mask": y_mask,
            "z": z,
            "z_p": z_p,
            "m_p": m_p_e,
            "logs_p": logs_p_e,
        }

    @torch.no_grad()
    def inference_packed(self, x, x_lengths, seg_sample, seg_pos, generator: torch.Generator,
                         noise_frames: int = 1000, noise_layout: str = "batch",
                         aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Many utterances decoded in a few dense rows (``utils/packing.py``).

        ``seg_sample``/``seg_pos`` ``[R, L]`` map each slot of the grid to
        its utterance (a row of ``x``; ``-1`` marks a gap) and to its frame
        within that utterance. The plan must come from the durations this
        call predicts, that is from :meth:`infer_durations` with the same
        generator state. Frame f of an utterance takes the prior of token t
        where ``cum[t-1] <= f < cum[t]`` over its cumulative durations: the
        alignment ``generate_path`` expands in :meth:`inference`, as a
        gather. The flow masks after every layer and the decoder after
        every conv with the grid's mask, so each segment decodes as it
        would alone, zero-padded.

        ``noise_layout="batch"`` draws the prior noise ``[B, noise_frames,
        C]`` and gathers it into the grid, so segment i gets the noise
        :meth:`inference` with ``max_frames=noise_frames`` gives row i;
        ``"packed"`` draws ``[R, L, C]`` straight in the grid's layout.

        ``aux_input`` holds one speaker and language per row of ``x``; each
        slot of the grid takes its utterance's speaker vector, so the flow
        and the decoder condition frame by frame and rows may mix speakers
        and languages."""
        a = self.args
        g, lang = self._cond_vectors(aux_input)
        w_ceil, m_p, logs_p, _ = self._durations(x, x_lengths, generator, g, lang)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

        valid = seg_sample >= 0
        s = torch.clamp(seg_sample, min=0).long()
        cum = torch.cumsum(w_ceil[:, :, 0], dim=1)  # [B, T_x]
        tok = torch.sum(cum[s] <= seg_pos[..., None].to(cum.dtype), dim=-1)
        tok = torch.clamp(tok, 0, m_p.shape[1] - 1)
        m_pk, logs_pk = m_p[s, tok], logs_p[s, tok]  # [R, L, C]
        if noise_layout == "packed":
            noise = modules.normal(m_pk.shape, generator)
        elif noise_layout == "batch":
            noise = modules.normal((x.shape[0], noise_frames, m_p.shape[-1]), generator)
            noise = noise[s, torch.clamp(seg_pos, max=noise_frames - 1).long()]
        else:
            raise ValueError(f"noise_layout must be 'batch' or 'packed', not {noise_layout!r}")
        mask = valid[..., None].to(m_pk.dtype)
        z_p = (m_pk + noise * torch.exp(logs_pk) * a.inference_noise_scale) * mask
        g_pk = g[s] if g is not None else None  # per-slot conditioning [R, L, C_g]
        z = self.flow(z_p, mask, g=g_pk)
        o = self.waveform_decoder(z * mask, g=g_pk, x_mask=mask)
        return {"model_outputs": o, "y_lengths": y_lengths, "packed_mask": valid,
                "durations": w_ceil}

    @torch.no_grad()
    def voice_conversion(self, y, y_lengths, g_src: torch.Tensor, g_tgt: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
        """Linear spectrogram ``[B, T, C_spec]`` spoken by ``g_src`` →
        waveform in the voice of ``g_tgt`` (speaker vectors ``[B, C_g]``):
        posterior sample, flow forward with the source, back with the
        target, decoder (port of ``tts_tpu/models/vits/model.py:429-443``).
        The latent is upsampled as in :meth:`inference`; the reference
        omits that step here, which would make an ``encoder_sample_rate``
        model's audio factor-times too short."""
        z, _, _, y_mask = self.posterior_encoder(y, y_lengths, generator, g=g_src)
        z_p = self.flow(z, y_mask, g=g_src, reverse=False)
        z_hat = self.flow(z_p, y_mask, g=g_tgt)
        return self.waveform_decoder(self._upsample_z(z_hat * y_mask), g=g_tgt)


# ---------------------------------------------------------------------------
# losses (port of tts_tpu/models/vits/model.py:449-484; reference
# TTS/tts/layers/losses.py:619-778)
# ---------------------------------------------------------------------------


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """KL(q || p) over the masked frames (reference ``losses.py:663``)."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)


def feature_loss(feats_real, feats_generated) -> torch.Tensor:
    """L1 feature matching x 2, the real features detached (reference
    ``losses.py:692``)."""
    loss = 0.0
    for dr_feats, dg_feats in zip(feats_real, feats_generated):
        for dr, dg in zip(dr_feats, dg_feats):
            loss = loss + torch.mean(torch.abs(dr.detach() - dg))
    return loss * 2.0


def generator_adv_loss(scores_fake) -> torch.Tensor:
    """LSGAN generator loss (reference ``losses.py:704``)."""
    loss = 0.0
    for dg in scores_fake:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def discriminator_adv_loss(scores_real, scores_fake):
    """LSGAN discriminator loss → ``(loss, real losses, fake losses)``
    (reference ``losses.py:744``)."""
    loss = 0.0
    real_losses, fake_losses = [], []
    for dr, dg in zip(scores_real, scores_fake):
        real_l = torch.mean((1.0 - dr) ** 2)
        fake_l = torch.mean(dg**2)
        loss = loss + real_l + fake_l
        real_losses.append(real_l)
        fake_losses.append(fake_l)
    return loss, real_losses, fake_losses


class Vits:
    """Host wrapper: tokenizer, weights and noise around :class:`VitsModule`,
    and the discriminator of training."""

    # inference() returns a waveform [B, T, 1] directly (no vocoder stage),
    # which the server's DynamicBatcher asks of a model
    emits_waveform = True
    # what the training step reads of the data pipeline's host work: the
    # waveform alone, its spectrograms taken on the device
    # (format_batch_on_device, F54), whatever the config's feature flags say
    dataset_features = {"compute_linear_spec": False, "compute_mel": False, "return_wav": True}

    def __init__(self, config: VitsConfig):
        check_supported(config)
        self.config = config
        self.args = config.model_args
        # eval mode: dropout acts only inside a training step (models/vits/train.py)
        self.module = VitsModule(self.args, interpolate_factor(config)).eval()
        # built without storage; init_params(discriminator=True) or
        # init_discriminator draws it, for training
        with torch.device("meta"):
            self.discriminator = modules.VitsDiscriminator(
                tuple(self.args.periods_multi_period_discriminator),
                width_mult=self.args.discriminator_width_mult)
        self.tokenizer: Optional[TTSTokenizer] = None
        self.speaker_manager = None
        self.language_manager = None
        # whether the generator holds drawn or loaded weights (init_params,
        # load_state_dict); the trainer draws a fresh model from config.seed
        self.initialized = False

    @classmethod
    def init_from_config(cls, config: VitsConfig) -> "Vits":
        """Tokenizer, managers and model for ``config``. The top level's
        speaker fields are mirrored into ``model_args`` (reference
        ``Vits.init_multispeaker``); the managers read each field from the
        top level or from ``model_args`` (ROADMAP.md F11) and write their
        counts into both."""
        tokenizer, config = TTSTokenizer.init_from_config(config)
        n_symbols = tokenizer.characters.num_chars
        if config.model_args.num_chars is None:
            config.model_args.num_chars = n_symbols
        if config.model_args.num_chars < n_symbols:
            # the JAX package embeds the ids past the table as NaN (ROADMAP.md F7)
            raise ValueError(
                f"model_args.num_chars={config.model_args.num_chars} is smaller than the "
                f"{n_symbols} symbols of {type(tokenizer.characters).__name__}: set it to "
                f"{n_symbols}, or to None to take the vocabulary's size"
            )
        for f in ("num_speakers", "use_speaker_embedding", "use_d_vector_file", "d_vector_dim"):
            if getattr(config, f, None):
                setattr(config.model_args, f, getattr(config, f))
        managers = init_speaker_manager(SimpleNamespace(), config)
        model = cls(config)
        model.tokenizer = tokenizer
        model.speaker_manager = managers.speaker_manager
        model.language_manager = managers.language_manager
        return model

    @property
    def device(self) -> torch.device:
        return self.module.text_encoder.emb.weight.device

    @property
    def uses_d_vectors(self) -> bool:
        """Whether speakers are given as d-vectors (``use_d_vector_file``)."""
        return bool(self.args.use_d_vector_file)

    @property
    def has_speakers(self) -> bool:
        """Whether the model is conditioned on a speaker (ids or d-vectors)."""
        a = self.args
        return bool(a.use_d_vector_file or (a.use_speaker_embedding and a.num_speakers > 0))

    @property
    def hop_length(self) -> int:
        """Waveform samples per latent frame: the decoder's upsampling (the
        iSTFT hop and bands included), times the latent's own upsampling."""
        a = self.args
        hop = int(np.prod(a.upsample_rates_decoder))
        if a.decoder_type == "istft":
            hop *= int(a.istft_hop_decoder) * int(a.istft_subbands_decoder)
        if a.interpolate_z:
            hop *= int(round(self.module.interpolate_factor))
        return hop

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", discriminator: bool = False) -> "Vits":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``. Norm scales are 1, biases
        and the duration flows' affine terms 0; linear and conv weights
        N(0, 1/fan_in), the last projection of each flow a tenth of that (so
        the flows start near the identity); the token embedding
        N(0, 1/hidden) and the relative-position tables N(0, 1/head width),
        the JAX package's scales for those two. With ``discriminator`` the
        discriminator is drawn too, after the generator from the same
        stream (:meth:`init_discriminator`), so the generator's weights do
        not depend on it."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = module.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or isinstance(owner, modules.ElementwiseAffine):
                p.zero_()
            elif isinstance(owner, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen) * self.args.hidden_channels**-0.5)
            elif leaf in ("emb_rel_k", "emb_rel_v"):
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[-1] ** -0.5)
            else:
                fan_in = p[0].numel() if not isinstance(owner, nn.ConvTranspose1d) else (
                    p.shape[0] * p.shape[2])
                scale = 0.1 if name.endswith((".post.weight", ".proj.weight")) and (
                    ".flow." in name) else 1.0
                p.copy_(torch.randn(p.shape, generator=gen) * scale / fan_in**0.5)
        self.module.to(device).requires_grad_(False)
        self.initialized = True
        if discriminator:
            self._draw_discriminator(gen, device)
        return self

    @property
    def has_discriminator(self) -> bool:
        """Whether the discriminator holds weights (not only its shapes)."""
        return not any(p.is_meta for p in self.discriminator.parameters())

    @torch.no_grad()
    def init_discriminator(self, seed: int = 0, device="cuda") -> "Vits":
        """Random fp32 discriminator weights from ``seed`` (drawn on the CPU,
        then moved to ``device``): conv weights N(0, 1/fan_in), biases 0."""
        self._draw_discriminator(torch.Generator().manual_seed(seed), resolve_device(device))
        return self

    def _draw_discriminator(self, gen: torch.Generator, device) -> None:
        disc = self.discriminator.to_empty(device="cpu")
        for name, p in disc.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
        self.discriminator = disc.to(device).requires_grad_(False)

    def load_discriminator_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Discriminator weights as they are (strict), e.g. from
        ``utils.convert.vits_discriminator_from_jax_params``."""
        self.discriminator.load_state_dict(state, strict=True, assign=True)
        self.discriminator.requires_grad_(False)

    def make_train_step(self, config: VitsConfig, generator: torch.Generator, device="cuda"):
        """The training hook (port of ``tts_tpu/models/vits/model.py:551``):
        ``(train_step, optimizers, state)`` for ``config``'s optimizers,
        schedules and loss weights, on ``device`` (CUDA unless the caller
        asks for the CPU). The generator network keeps its current weights;
        a discriminator not drawn yet is drawn from seed 0. ``train_step(state,
        batch)`` makes every draw from ``generator``, which must live on
        ``device`` (see ``models/vits/train.py``)."""
        from .train import create_train_state, make_train_step

        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"the step's generator is on {generator.device}, the model on "
                             f"{device}")
        if not self.has_discriminator:
            self.init_discriminator(0, device)
        self.module.to(device)
        self.discriminator.to(device)
        state = create_train_state(self, config)
        step_fn, eval_fn, optimizers = make_train_step(self, config)
        self._eval_step_fn = eval_fn
        return functools.partial(step_fn, generator=generator), optimizers, state

    def make_eval_step(self, config: VitsConfig):
        """The deterministic no-grad evaluation of the losses (port of
        ``tts_tpu/models/vits/model.py:560``)."""
        if getattr(self, "_eval_step_fn", None) is None:
            from .train import make_train_step

            _, self._eval_step_fn, _ = make_train_step(self, config)
        return self._eval_step_fn

    def format_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The data pipeline's numpy batch → the step's keys, on the host
        (port of ``tts_tpu/models/vits/model.py:568``): ``spec_lengths`` from
        ``mel_lengths``, with or without a host ``spec`` (the step's is taken
        on the device, :meth:`format_batch_on_device`). With ``encoder_sample_rate`` below the output rate
        the posterior encoder reads spectrograms at the encoder's rate: the
        waveform is resampled down and its spectrogram taken here, as the
        JAX package does (reference ``vits.py:1495-1516``), but as the
        reference's linear magnitude (``wav_to_spec``), not the
        ``AudioProcessor``'s decibels (ROADMAP.md F54)."""
        if "mel_lengths" in batch and "spec_lengths" not in batch:
            batch["spec_lengths"] = batch["mel_lengths"]
        f = int(round(self.module.interpolate_factor))
        if f > 1 and batch.get("waveform") is not None:
            from tts_tpu_torch.audio import numpy_transforms as nt
            from tts_tpu_torch.audio.torch_transforms import wav_to_spec

            audio = self.config.audio
            sr = audio.sample_rate
            wavs = np.asarray(batch["waveform"], np.float32)[..., 0]
            specs = [
                wav_to_spec(torch.from_numpy(np.ascontiguousarray(
                    nt.resample_wav(w, sr, self.args.encoder_sample_rate),
                    dtype=np.float32))[None], audio.fft_size, audio.hop_length,
                    audio.win_length)[0].T.numpy()
                for w in wavs
            ]
            T = max(s.shape[0] for s in specs)
            batch["spec"] = np.stack([np.pad(s, ((0, T - s.shape[0]), (0, 0))) for s in specs])
            batch["spec_lengths"] = np.minimum(
                np.asarray(batch["mel_lengths"]) // f, T
            ).astype(np.int32)
        return batch

    def format_batch_on_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The posterior encoder's input from the waveform on the device:
        the linear magnitude spectrogram ``[B, T, C]`` of ``wav_to_spec``, as
        the reference's ``format_batch_on_device`` computes it
        (``vits.py:1495-1516``). The JAX package feeds the data pipeline's
        ``AudioProcessor`` spectrogram, in decibels (ROADMAP.md F54, as F15
        for voice conversion). A batch without a waveform keeps its
        ``spec``; the ``encoder_sample_rate`` variant's comes from
        :meth:`format_batch`."""
        if batch.get("waveform") is None or int(round(self.module.interpolate_factor)) > 1:
            return batch
        from tts_tpu_torch.audio.torch_transforms import wav_to_spec

        audio = self.config.audio
        spec = wav_to_spec(batch["waveform"][..., 0].float(), audio.fft_size, audio.hop_length,
                           audio.win_length)
        batch["spec"] = spec.transpose(1, 2).contiguous()
        return batch

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)
        self.initialized = True

    def load_checkpoint(self, config: VitsConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "Vits":
        """Weights from a file: the port's state_dict of :class:`VitsModule`
        (``model_torch.pt``) or a reference-layout checkpoint (``model.pth``,
        weight norm folded and converted). ``checkpoint_dir`` looks for those
        two names in turn."""
        device = resolve_device(device)
        if checkpoint_path is None:
            for name in (PORT_WEIGHTS, REFERENCE_WEIGHTS):
                if os.path.isfile(os.path.join(checkpoint_dir, name)):
                    checkpoint_path = os.path.join(checkpoint_dir, name)
                    break
            else:
                raise FileNotFoundError(
                    f"No model weights in {checkpoint_dir} (need {PORT_WEIGHTS} or "
                    f"{REFERENCE_WEIGHTS})"
                )
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(self.module.state_dict()):
            from tts_tpu_torch.utils.convert import load_reference_vits

            state = load_reference_vits(state, self.args)
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    # ------------------------------------------------------------------
    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    def infer_durations(self, x, x_lengths, generator: Optional[torch.Generator] = None,
                        aux_input: Optional[Dict] = None) -> torch.Tensor:
        """Predicted frame counts ``[B]``. Pass the generator state that the
        following :meth:`inference` call starts from to get its durations."""
        return self.module.infer_durations(x, x_lengths, self._generator(generator),
                                           aux_input=aux_input)

    def durations(self, x, x_lengths, generator: Optional[torch.Generator] = None,
                  aux_input: Optional[Dict] = None) -> torch.Tensor:
        """Each token's frame count ``[B, T_x, 1]`` (:meth:`VitsModule.durations`);
        :meth:`infer_durations` sums them."""
        return self.module.durations(x, x_lengths, self._generator(generator),
                                     aux_input=aux_input)

    def inference(self, x, x_lengths, max_frames: int = 1000,
                  generator: Optional[torch.Generator] = None,
                  aux_input: Optional[Dict] = None,
                  durations: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """``aux_input``: ``speaker_ids [B]``, ``d_vectors [B, C]`` and
        ``language_ids [B]`` on the model's device, as the model takes
        them. ``durations`` (from :meth:`durations`) replace the duration
        predictor's draw."""
        if self.args.max_inference_len:
            # cap the decoder length (reference vits.py:650,1167)
            max_frames = min(max_frames, int(self.args.max_inference_len))
        return self.module.inference(x, x_lengths, self._generator(generator),
                                     max_frames=max_frames, aux_input=aux_input,
                                     durations=durations)

    @property
    def supports_packed_decode(self) -> bool:
        return supports_packed_decode(self.config)

    def inference_packed(self, x, x_lengths, seg_sample, seg_pos, noise_frames: int = 1000,
                         noise_layout: str = "batch",
                         generator: Optional[torch.Generator] = None,
                         aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Sequence-packed decode (:meth:`VitsModule.inference_packed`) of a
        plan from ``utils.packing.plan_pack_layout`` (numpy or tensors) over
        :meth:`infer_durations`' lengths, made with the same generator
        state and ``aux_input``. Raises ``ValueError`` for a model that
        :attr:`supports_packed_decode` refuses (ROADMAP.md F2)."""
        if not self.supports_packed_decode:
            raise ValueError("the sequence-packed decode needs the masked HiFiGAN decoder at "
                             "the encoder's rate; the istft and interpolate_z variants are "
                             "served by duration-grouped decodes (ROADMAP.md F2)")
        seg_sample = torch.as_tensor(seg_sample, device=self.device)
        seg_pos = torch.as_tensor(seg_pos, device=self.device)
        return self.module.inference_packed(x, x_lengths, seg_sample, seg_pos,
                                            self._generator(generator),
                                            noise_frames=noise_frames,
                                            noise_layout=noise_layout, aux_input=aux_input)

    def _speaker_vector(self, cond) -> torch.Tensor:
        """Speaker ids (integers, ``[B]``) → ``emb_g`` rows; d-vectors
        (floats, ``[B, C]``) L2-normalised (ROADMAP.md F26)."""
        cond = torch.as_tensor(cond, device=self.device)
        if not cond.is_floating_point():
            return self.module.emb_g(cond.reshape(-1).long())
        return normalize_d_vectors(cond.reshape(-1, cond.shape[-1]).float())

    def voice_conversion(self, y, y_lengths, speaker_cond_src, speaker_cond_tgt,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Same-model voice transfer (port of ``tts_tpu/models/vits/model.py:598-617``):
        the linear spectrogram ``y`` ``[B, T, C_spec]`` spoken by the source
        speaker → waveform ``[B, T * hop, 1]`` in the target's voice. Each
        speaker is given by id (integers) or d-vector (floats). The
        posterior sample draws from ``generator`` (seeded 0 by default, as
        the JAX package draws from ``PRNGKey(0)``). A model without speakers
        raises ``ValueError``."""
        if not self.has_speakers:
            raise ValueError("voice conversion needs a multi-speaker model (speaker "
                             "embeddings or d-vectors)")
        y = torch.as_tensor(y, device=self.device)
        y_lengths = torch.as_tensor(y_lengths, device=self.device)
        return self.module.voice_conversion(
            y, y_lengths, self._speaker_vector(speaker_cond_src),
            self._speaker_vector(speaker_cond_tgt), self._generator(generator))
