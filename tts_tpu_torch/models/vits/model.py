"""VITS text → waveform inference (port of ``tts_tpu/models/vits/model.py``):
``VitsModule`` (the generator: text encoder, duration predictor, coupling
flow, HiFiGAN decoder; the posterior encoder is built so weights load
strictly) and the ``Vits`` host wrapper (tokenizer, weights, noise).

The port runs the single-speaker HiFiGAN variant, one utterance per row
(``inference``) or many packed into a few rows (``inference_packed``). The
multi-speaker and multi-language fields, ``encoder_sample_rate``
(``interpolate_z``), the ``istft`` decoder, voice conversion and training
raise ``NotImplementedError`` (ROADMAP.md, slice 2b and later).

Noise: each ``inference``/``inference_packed``/``infer_durations`` call
draws from a ``torch.Generator`` on the model's device, seeded 0 unless the
caller passes one, as the JAX package draws from ``PRNGKey(0)`` by default.
All three make the same first draw, so a durations pass and the decode
after it agree, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.common import DurationPredictor
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
from tts_tpu_torch.text.tokenizer import TTSTokenizer
from tts_tpu_torch.vocoder.models.hifigan_generator import HifiganGenerator

from . import modules
from .config import VitsArgs, VitsConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of VitsModule
REFERENCE_WEIGHTS = "model.pth"  # a reference-layout (coqui) checkpoint

_ROADMAP = "is not ported to tts_tpu_torch yet (ROADMAP.md, slice 2b)"


def check_supported(config: VitsConfig) -> None:
    """Raise on every VITS variant the port does not run yet."""
    a = config.model_args
    multi = {
        "use_speaker_embedding": a.use_speaker_embedding or config.use_speaker_embedding,
        "use_d_vector_file": a.use_d_vector_file or config.use_d_vector_file,
        "use_language_embedding": a.use_language_embedding,
    }
    for name, on in multi.items():
        if on:
            raise NotImplementedError(f"multi-speaker/-language VITS ({name}=True) {_ROADMAP}")
    if a.encoder_sample_rate:
        raise NotImplementedError(f"VITS with encoder_sample_rate (interpolate_z) {_ROADMAP}")
    if a.decoder_type != "hifigan":
        raise NotImplementedError(f"VITS decoder_type={a.decoder_type!r} {_ROADMAP}")


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
    """The VITS generator (everything except the discriminator), for one
    speaker."""

    def __init__(self, args: VitsArgs):
        super().__init__()
        self.args = args
        self.text_encoder = modules.TextEncoder(
            n_vocab=args.num_chars,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            hidden_channels_ffn=args.hidden_channels_ffn_text_encoder,
            num_heads=args.num_heads_text_encoder,
            num_layers=args.num_layers_text_encoder,
            kernel_size=args.kernel_size_text_encoder,
        )
        self.posterior_encoder = modules.PosteriorEncoder(
            in_channels=args.out_channels,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_posterior_encoder,
            dilation_rate=args.dilation_rate_posterior_encoder,
            num_layers=args.num_layers_posterior_encoder,
        )
        self.flow = modules.ResidualCouplingBlocks(
            channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_flow,
            dilation_rate=args.dilation_rate_flow,
            num_layers=args.num_layers_flow,
        )
        if args.use_sdp:
            self.duration_predictor = modules.StochasticDurationPredictor(
                in_channels=args.hidden_channels, hidden_channels=192, kernel_size=3,
                num_flows=4,
            )
        else:
            self.duration_predictor = DurationPredictor(
                in_channels=args.hidden_channels, hidden_channels=256, kernel_size=3
            )
        self.waveform_decoder = HifiganGenerator(
            in_channels=args.hidden_channels,
            out_channels=1,
            resblock_type=args.resblock_type_decoder,
            resblock_dilation_sizes=[tuple(d) for d in args.resblock_dilation_sizes_decoder],
            resblock_kernel_sizes=tuple(args.resblock_kernel_sizes_decoder),
            upsample_kernel_sizes=tuple(args.upsample_kernel_sizes_decoder),
            upsample_initial_channel=args.upsample_initial_channel_decoder,
            upsample_factors=tuple(args.upsample_rates_decoder),
            conv_post_bias=False,
        )

    def _durations(self, x, x_lengths, generator):
        """Text encoder and duration predictor: ``(w_ceil [B, T_x, 1], m_p,
        logs_p, x_mask)``. With the stochastic predictor this makes the
        call's first noise draw."""
        a = self.args
        x_hid, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths)
        if a.use_sdp:
            logw = self.duration_predictor(x_hid, x_mask, generator,
                                           noise_scale=a.inference_noise_scale_dp)
        else:
            logw = self.duration_predictor(x_hid, x_mask)
        w = torch.exp(logw) * x_mask * a.length_scale
        return torch.ceil(w) * x_mask, m_p, logs_p, x_mask

    @torch.no_grad()
    def infer_durations(self, x, x_lengths, generator: torch.Generator) -> torch.Tensor:
        """Predicted output frame counts ``[B]`` (int32, at least 1)."""
        w_ceil = self._durations(x, x_lengths, generator)[0]
        return torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

    @torch.no_grad()
    def inference(self, x, x_lengths, generator: torch.Generator,
                  max_frames: int = 1000) -> Dict[str, Any]:
        """Text ids ``[B, T_x]`` → waveform ``[B, max_frames * hop, 1]``. The
        whole frame budget is decoded, as in the JAX package: frames past
        ``y_lengths`` are zero going into the decoder, but its convolutions
        reach over the boundary."""
        a = self.args
        w_ceil, m_p, logs_p, x_mask = self._durations(x, x_lengths, generator)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), 1, max_frames).to(torch.int32)
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None].to(x_mask.dtype)
        attn_mask = x_mask * y_mask.transpose(1, 2)
        attn = generate_path(w_ceil[:, :, 0], attn_mask)  # [B, T_x, T_y]

        m_p_e = torch.bmm(attn.transpose(1, 2), m_p)
        logs_p_e = torch.bmm(attn.transpose(1, 2), logs_p)
        noise = modules.normal(m_p_e.shape, generator)
        z_p = m_p_e + noise * torch.exp(logs_p_e) * a.inference_noise_scale
        z = self.flow(z_p * y_mask, y_mask)
        o = self.waveform_decoder(z * y_mask)
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
                         noise_frames: int = 1000, noise_layout: str = "batch") -> Dict[str, Any]:
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
        ``"packed"`` draws ``[R, L, C]`` straight in the grid's layout."""
        a = self.args
        w_ceil, m_p, logs_p, _ = self._durations(x, x_lengths, generator)
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
        z = self.flow(z_p, mask)
        o = self.waveform_decoder(z * mask, x_mask=mask)
        return {"model_outputs": o, "y_lengths": y_lengths, "packed_mask": valid,
                "durations": w_ceil}


class Vits:
    """Host wrapper: tokenizer, weights and noise around :class:`VitsModule`."""

    # inference() returns a waveform [B, T, 1] directly (no vocoder stage),
    # which the server's DynamicBatcher asks of a model
    emits_waveform = True

    def __init__(self, config: VitsConfig):
        check_supported(config)
        self.config = config
        self.args = config.model_args
        self.module = VitsModule(self.args)
        self.tokenizer: Optional[TTSTokenizer] = None

    @classmethod
    def init_from_config(cls, config: VitsConfig) -> "Vits":
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
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.text_encoder.emb.weight.device

    @property
    def hop_length(self) -> int:
        """Waveform samples per latent frame."""
        return int(np.prod(self.args.upsample_rates_decoder))

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

    def infer_durations(self, x, x_lengths,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Predicted frame counts ``[B]``. Pass the generator state that the
        following :meth:`inference` call starts from to get its durations."""
        return self.module.infer_durations(x, x_lengths, self._generator(generator))

    def inference(self, x, x_lengths, max_frames: int = 1000,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        if self.args.max_inference_len:
            # cap the decoder length (reference vits.py:650,1167)
            max_frames = min(max_frames, int(self.args.max_inference_len))
        return self.module.inference(x, x_lengths, self._generator(generator),
                                     max_frames=max_frames)

    @property
    def supports_packed_decode(self) -> bool:
        return supports_packed_decode(self.config)

    def inference_packed(self, x, x_lengths, seg_sample, seg_pos, noise_frames: int = 1000,
                         noise_layout: str = "batch",
                         generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Sequence-packed decode (:meth:`VitsModule.inference_packed`) of a
        plan from ``utils.packing.plan_pack_layout`` (numpy or tensors) over
        :meth:`infer_durations`' lengths, made with the same generator
        state."""
        seg_sample = torch.as_tensor(seg_sample, device=self.device)
        seg_pos = torch.as_tensor(seg_pos, device=self.device)
        return self.module.inference_packed(x, x_lengths, seg_sample, seg_pos,
                                            self._generator(generator),
                                            noise_frames=noise_frames,
                                            noise_layout=noise_layout)

    def voice_conversion(self, *args, **kwargs):
        raise NotImplementedError(f"VITS voice_conversion {_ROADMAP}")
