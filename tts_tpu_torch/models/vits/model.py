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
reference does not (the JAX package's named divergence). Training waits
for its own slice (ROADMAP.md item 17).

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

import os
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.common import DurationPredictor
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
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
            )
        else:
            self.duration_predictor = DurationPredictor(
                in_channels=args.hidden_channels + lang_dim, hidden_channels=256,
                kernel_size=3, cond_channels=dp_cond,
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
    def infer_durations(self, x, x_lengths, generator: torch.Generator,
                        aux_input: Optional[Dict] = None) -> torch.Tensor:
        """Predicted output frame counts ``[B]`` (int32, at least 1)."""
        w_ceil = self._durations(x, x_lengths, generator, *self._cond_vectors(aux_input))[0]
        return torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

    @torch.no_grad()
    def inference(self, x, x_lengths, generator: torch.Generator, max_frames: int = 1000,
                  aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Text ids ``[B, T_x]`` → waveform ``[B, max_frames * hop, 1]``. The
        whole frame budget is decoded, as in the JAX package: frames past
        ``y_lengths`` are zero going into the decoder, but its convolutions
        reach over the boundary."""
        a = self.args
        g, lang = self._cond_vectors(aux_input)
        w_ceil, m_p, logs_p, x_mask = self._durations(x, x_lengths, generator, g, lang)
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


class Vits:
    """Host wrapper: tokenizer, weights and noise around :class:`VitsModule`."""

    # inference() returns a waveform [B, T, 1] directly (no vocoder stage),
    # which the server's DynamicBatcher asks of a model
    emits_waveform = True

    def __init__(self, config: VitsConfig):
        check_supported(config)
        self.config = config
        self.args = config.model_args
        self.module = VitsModule(self.args, interpolate_factor(config))
        self.tokenizer: Optional[TTSTokenizer] = None
        self.speaker_manager = None
        self.language_manager = None

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
    def init_params(self, seed: int = 0, device="cuda") -> "Vits":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``. Norm scales are 1, biases
        and the duration flows' affine terms 0; linear and conv weights
        N(0, 1/fan_in), the last projection of each flow a tenth of that (so
        the flows start near the identity); the token embedding
        N(0, 1/hidden) and the relative-position tables N(0, 1/head width),
        the JAX package's scales for those two."""
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
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)

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

    def inference(self, x, x_lengths, max_frames: int = 1000,
                  generator: Optional[torch.Generator] = None,
                  aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """``aux_input``: ``speaker_ids [B]``, ``d_vectors [B, C]`` and
        ``language_ids [B]`` on the model's device, as the model takes
        them."""
        if self.args.max_inference_len:
            # cap the decoder length (reference vits.py:650,1167)
            max_frames = min(max_frames, int(self.args.max_inference_len))
        return self.module.inference(x, x_lengths, self._generator(generator),
                                     max_frames=max_frames, aux_input=aux_input)

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
