"""ForwardTTS text → mel inference: FastPitch, FastSpeech, FastSpeech2 and
SpeedySpeech (port of ``tts_tpu/models/forward_tts/model.py``, reference
``TTS/tts/models/forward_tts.py``). ``ForwardTTSModule.inference``: token
embedding, encoder (``FFTransformerBlock`` or ``ResidualConv1dBNBlock``),
the speaker vector added, log-durations rounded to frames (at least one a
token, times ``length_scale``), the pitch and energy adaptors, expansion
through the monotonic path (``generate_path``), positional encoding, the
decoder and the projection to the mel. ``ForwardTTS`` is the host wrapper
(tokenizer, managers, weights).

The decode runs at a frame budget (``max_frames``): ``y_lengths`` is cut
there, as in the JAX package. Training (``tts_tpu/models/forward_tts/
model.py:142-215,247-296,347-350``): ``ForwardTTSModule.forward`` is the
teacher-forced pass, with the aligner (``layers.aligner``, built last so
that the other layers' draws in ``init_params`` stay as they were) and MAS
(``ops.mas.maximum_path``, K2 on CUDA) on its log-probabilities masked with
-1e9, the durations it finds feeding ``average_over_durations`` of the
pitch and energy targets and the expansion; ``forward_tts_loss`` gives the
spectral, SSIM, duration, pitch, energy, forward-sum and binary alignment
losses; ``ForwardTTS.train_step`` is the trainer's generic step's loss.

Three divergences from the JAX package, each named in its test:

* F24: ``ForwardTTS.init_from_config`` attaches a speaker manager, from the
  config's top level or from ``model_args`` (F11's rule), and mirrors the
  top level's speaker fields into ``model_args``, as the port's VITS does.
  The JAX wrapper builds none, and its module reads ``model_args`` alone, so
  the VCTK FastPitch recipe (``use_speaker_embedding`` on the top level)
  decodes every sentence without a speaker there.
* F27: the JAX module adds a d-vector straight to the encoder output and
  has no projection for a ``d_vector_dim`` other than ``hidden_channels``
  (the reference's ``proj_g``); the port raises on such a config before
  anything is built, for training as for inference.
* F61: the JAX step weighs the binary alignment loss by 1 always, its
  ``binary_loss_warmup_epochs`` unread; the port sets the weight at each
  step's start to ``min(epochs_done / binary_loss_warmup_epochs, 1)``, as
  the reference's ``on_train_step_start`` does.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers import losses as L
from tts_tpu_torch.layers.aligner import AlignmentNetwork
from tts_tpu_torch.layers.common import Conv1d, DurationPredictor, use_dropout_generator
from tts_tpu_torch.layers.feed_forward import (
    FFTransformerBlock,
    PositionalEncoding,
    ResidualConv1dBNBlock,
)
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import average_over_durations, generate_path, sequence_mask
from tts_tpu_torch.ops.mas import maximum_path
from tts_tpu_torch.text.tokenizer import TTSTokenizer
from tts_tpu_torch.utils.managers import config_setting, init_speaker_manager

from .config import ForwardTTSArgs, ForwardTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of ForwardTTSModule
REFERENCE_WEIGHTS = ("model_file.pth", "model.pth")  # reference-layout (coqui) checkpoints
_SPEAKER_FIELDS = ("num_speakers", "use_speaker_embedding", "use_d_vector_file", "d_vector_dim")


def check_supported(config: ForwardTTSConfig) -> None:
    """F27: a d-vector narrower or wider than ``hidden_channels`` needs the
    reference's ``proj_g``, which the JAX package lacks; raise."""
    if not config_setting(config, "use_d_vector_file"):
        return
    dim = config_setting(config, "d_vector_dim")
    hidden = config.model_args.hidden_channels
    if dim and dim != hidden:
        raise NotImplementedError(
            f"F27: d_vector_dim {dim} differs from hidden_channels {hidden}; the reference "
            f"projects such d-vectors with proj_g, which neither tts_tpu nor tts_tpu_torch "
            f"has (ROADMAP.md F27)")


def _make_block(kind: str, channels: int, params: dict) -> nn.Module:
    if kind == "fftransformer":
        return FFTransformerBlock(channels, params.get("num_heads", 1),
                                  params.get("hidden_channels_ffn", 1024),
                                  params.get("num_layers", 6), params.get("dropout_p", 0.1))
    if kind == "residual_conv_bn":
        return ResidualConv1dBNBlock(channels, channels, params.get("kernel_size", 4),
                                     tuple(params.get("dilations", [1, 2, 4] * 4 + [1])),
                                     params.get("num_conv_blocks", 2))
    raise ValueError(f"Unknown encoder/decoder type {kind!r}")


class ForwardTTSModule(nn.Module):
    """The ForwardTTS network (the aligner with ``use_aligner``)."""

    def __init__(self, args: ForwardTTSArgs):
        super().__init__()
        a = self.args = args
        self.emb = nn.Embedding(a.num_chars, a.hidden_channels)
        self.encoder = _make_block(a.encoder_type, a.hidden_channels, a.encoder_params)
        self.decoder = _make_block(a.decoder_type, a.hidden_channels, a.decoder_params)
        if a.positional_encoding:
            self.pos_encoder = PositionalEncoding(a.hidden_channels,
                                                  use_scale=a.positional_encoding_use_scale)
        self.duration_predictor = DurationPredictor(
            a.hidden_channels, a.duration_predictor_hidden_channels,
            a.duration_predictor_kernel_size, dropout_p=a.duration_predictor_dropout_p)
        if a.use_pitch:
            self.pitch_predictor = DurationPredictor(
                a.hidden_channels, a.pitch_predictor_hidden_channels,
                a.pitch_predictor_kernel_size, dropout_p=a.pitch_predictor_dropout_p)
            self.pitch_emb = Conv1d(1, a.hidden_channels, a.pitch_embedding_kernel_size)
        if a.use_energy:
            self.energy_predictor = DurationPredictor(
                a.hidden_channels, a.energy_predictor_hidden_channels,
                a.energy_predictor_kernel_size, dropout_p=a.energy_predictor_dropout_p)
            self.energy_emb = Conv1d(1, a.hidden_channels, a.energy_embedding_kernel_size)
        self.proj = nn.Linear(a.hidden_channels, a.out_channels)
        if a.use_speaker_embedding and a.num_speakers > 1:
            self.emb_g = nn.Embedding(a.num_speakers, a.hidden_channels)
        if a.use_aligner:
            self.aligner = AlignmentNetwork(in_query_channels=a.out_channels,
                                            in_key_channels=a.hidden_channels)

    def _speaker_vec(self, aux_input: Optional[Dict]) -> Optional[torch.Tensor]:
        """``emb_g`` of ``speaker_ids`` (a speaker-embedding model), else the
        ``d_vectors`` as they are, else ``None``."""
        if not aux_input:
            return None
        if aux_input.get("speaker_ids") is not None and self.args.use_speaker_embedding:
            return self.emb_g(aux_input["speaker_ids"])
        return aux_input.get("d_vectors")

    def _encode(self, x, x_mask, g=None):
        """The encoder output with the speaker vector added, and the token
        embedding (the aligner's keys)."""
        x_emb = self.emb(x)
        h = self.encoder(x_emb * x_mask, x_mask)
        if g is not None:
            h = h + g[:, None, :]
        return h, x_emb

    @staticmethod
    def _expand(en, dr, x_mask, y_mask):
        """Encoder states repeated by their durations: ``[B, T_de, C]`` and
        the path ``[B, T_en, T_de]``."""
        attn = generate_path(dr, x_mask * y_mask.transpose(1, 2))
        return torch.einsum("bxy,bxc->byc", attn, en), attn

    def _decode(self, o_en_ex, y_mask):
        if self.args.positional_encoding:
            o_en_ex = self.pos_encoder(o_en_ex, y_mask)
        return self.proj(self.decoder(o_en_ex, y_mask)) * y_mask

    @staticmethod
    def _adapt(predictor, emb, o_en, x_mask, target=None, dr=None):
        """A pitch or energy adaptor: the predictor's ``[B, T_en, 1]`` and
        the encoder output plus the embedding of the target averaged over
        each token's frames (training) or of the prediction (inference)."""
        pred = predictor(o_en, x_mask)
        avg = None if target is None else average_over_durations(target, dr.long())
        value = pred if avg is None else avg
        return pred, avg, o_en + emb(value.transpose(1, 2)).transpose(1, 2)

    def _forward_aligner(self, x_emb, y, x_mask, y_mask, attn_prior=None):
        """The aligner's soft attention and log-probabilities, and MAS (K2)
        on the log-probabilities masked with -1e9: ``(durations [B, T_en],
        soft [B, T_en, T_de], logp [B, T_de, T_en], path [B, T_en, T_de])``
        (reference ``forward_tts.py:525``)."""
        attn_mask = x_mask * y_mask.transpose(1, 2)  # [B, T_en, T_de]
        attn_soft, attn_logp = self.aligner(y, x_emb, mask=y_mask[..., 0],
                                            attn_prior=attn_prior)
        logp = attn_logp.transpose(1, 2).detach()
        logp = torch.where(attn_mask > 0, logp, torch.full_like(logp, -1e9))
        attn_mas = maximum_path(logp, attn_mask)
        return attn_mas.sum(dim=-1), attn_soft.transpose(1, 2), attn_logp, attn_mas

    def forward(self, x, x_lengths, y_lengths, y, dr=None, pitch=None, energy=None,
                attn_priors=None, aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """The teacher-forced training pass: token ids ``[B, T_en]``, the mel
        ``y [B, T_de, C]``; ``dr [B, T_en]`` when there is no aligner,
        ``pitch``/``energy [B, T_de, 1]`` with the adaptors. The duration
        predictor sees the encoder output detached with
        ``detach_duration_predictor``."""
        a = self.args
        g = self._speaker_vec(aux_input)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(y.dtype)
        y_mask = sequence_mask(y_lengths, y.shape[1])[:, :, None].to(y.dtype)
        o_en, x_emb = self._encode(x, x_mask, g)
        dp_input = o_en.detach() if a.detach_duration_predictor else o_en
        o_dr_log = self.duration_predictor(dp_input, x_mask)[..., 0]
        o_dr = torch.clamp(torch.exp(o_dr_log) - 1, 0, a.max_duration)
        o_alignment_dur = alignment_soft = alignment_logprob = alignment_mas = None
        if a.use_aligner:
            o_alignment_dur, alignment_soft, alignment_logprob, alignment_mas = (
                self._forward_aligner(x_emb, y, x_mask, y_mask, attn_priors))
            dr = o_alignment_dur
        o_pitch = avg_pitch = o_energy = avg_energy = None
        if a.use_pitch:
            o_pitch, avg_pitch, o_en = self._adapt(self.pitch_predictor, self.pitch_emb, o_en,
                                                   x_mask, pitch, dr)
        if a.use_energy:
            o_energy, avg_energy, o_en = self._adapt(self.energy_predictor, self.energy_emb,
                                                     o_en, x_mask, energy, dr)
        o_en_ex, attn = self._expand(o_en, dr, x_mask, y_mask)
        return {
            "model_outputs": self._decode(o_en_ex, y_mask),
            "durations_log": o_dr_log,
            "durations": o_dr,
            "pitch_avg": o_pitch,
            "pitch_avg_gt": avg_pitch,
            "energy_avg": o_energy,
            "energy_avg_gt": avg_energy,
            "alignments": attn.transpose(1, 2),
            "alignment_soft": alignment_soft,
            "alignment_mas": alignment_mas,
            "o_alignment_dur": o_alignment_dur,
            "alignment_logprob": alignment_logprob,
            "x_mask": x_mask,
            "y_mask": y_mask,
        }

    def durations(self, o_en, x_mask) -> torch.Tensor:
        """Frames a token ``[B, T_en]``: ``round((exp(log_dur) - 1) ·
        length_scale)``, at least 1 for a valid token, 0 for padding."""
        o_dr_log = self.duration_predictor(o_en, x_mask)[..., 0]
        mask = x_mask[..., 0]
        o_dr = (torch.exp(o_dr_log) - 1) * mask * self.args.length_scale
        return torch.clamp(torch.round(o_dr), min=1.0) * mask

    def encode(self, x, x_lengths, aux_input: Optional[Dict] = None,
               max_frames: int = 1000) -> Dict[str, torch.Tensor]:
        """Everything before the expansion: the encoder with the speaker
        vector, the durations and frame counts (cut at ``max_frames``), the
        pitch and energy adaptors."""
        a = self.args
        g = self._speaker_vec(aux_input)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].float()
        o_en = self._encode(x, x_mask, g)[0]
        o_dr = self.durations(o_en, x_mask)
        y_lengths = torch.clamp(o_dr.sum(dim=1), 1, max_frames).long()
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None].float()
        if a.use_pitch:
            o_en = self._adapt(self.pitch_predictor, self.pitch_emb, o_en, x_mask)[2]
        if a.use_energy:
            o_en = self._adapt(self.energy_predictor, self.energy_emb, o_en, x_mask)[2]
        return {"o_en": o_en, "durations": o_dr, "x_mask": x_mask, "y_lengths": y_lengths,
                "y_mask": y_mask}

    def inference(self, x, x_lengths, aux_input: Optional[Dict] = None,
                  max_frames: int = 1000) -> Dict[str, Any]:
        """Token ids ``[B, T_en]`` → mel ``[B, max_frames, C]`` with the frame
        counts in ``y_lengths`` (cut at ``max_frames``)."""
        e = self.encode(x, x_lengths, aux_input, max_frames)
        o_en_ex, attn = self._expand(e["o_en"], e["durations"], e["x_mask"], e["y_mask"])
        return {
            "model_outputs": self._decode(o_en_ex, e["y_mask"]),
            "alignments": attn.transpose(1, 2),
            "durations": e["durations"],
            "y_lengths": e["y_lengths"],
            "y_mask": e["y_mask"],
        }


def forward_tts_loss(config: ForwardTTSConfig, outputs: Dict[str, Any], batch: Dict,
                     binary_loss_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """The weighted sum of the losses the config switches on (reference
    ``losses.py:779`` ForwardTTSLoss), and each loss, as the JAX
    ``forward_tts_loss``; the binary alignment loss's weight is also
    multiplied by ``binary_loss_weight`` (F61's schedule)."""
    a = config.model_args
    loss = 0.0
    out: Dict[str, torch.Tensor] = {}
    mel, mel_lens, text_lens = batch["mel_input"], batch["mel_lengths"], batch["text_lengths"]
    if config.use_ssim_loss and config.ssim_loss_alpha > 0:
        out["loss_ssim"] = L.ssim_loss(outputs["model_outputs"], mel, mel_lens)
        loss = loss + config.ssim_loss_alpha * out["loss_ssim"]
    if config.spec_loss_alpha > 0:
        spec_fn = L.mse_loss_masked if config.spec_loss_type == "mse" else L.l1_loss_masked
        out["loss_spec"] = spec_fn(outputs["model_outputs"], mel, mel_lens)
        loss = loss + config.spec_loss_alpha * out["loss_spec"]
    if config.dur_loss_alpha > 0:
        dur_target = outputs["o_alignment_dur"] if a.use_aligner else batch["durations"]
        log_dur_tgt = torch.log1p(dur_target.float())[:, :, None]
        dur_fn = L.huber_loss if config.duration_loss_type == "huber" else L.mse_loss_masked
        out["loss_dur"] = dur_fn(outputs["durations_log"][:, :, None], log_dur_tgt, text_lens)
        loss = loss + config.dur_loss_alpha * out["loss_dur"]
    if a.use_pitch and config.pitch_loss_alpha > 0:
        out["loss_pitch"] = L.mse_loss_masked(outputs["pitch_avg"], outputs["pitch_avg_gt"],
                                              text_lens)
        loss = loss + config.pitch_loss_alpha * out["loss_pitch"]
    if a.use_energy and config.energy_loss_alpha > 0:
        out["loss_energy"] = L.mse_loss_masked(outputs["energy_avg"], outputs["energy_avg_gt"],
                                               text_lens)
        loss = loss + config.energy_loss_alpha * out["loss_energy"]
    if a.use_aligner and config.aligner_loss_alpha > 0:
        out["loss_aligner"] = L.forward_sum_loss(outputs["alignment_logprob"], text_lens,
                                                 mel_lens)
        loss = loss + config.aligner_loss_alpha * out["loss_aligner"]
    if config.binary_align_loss_alpha > 0 and outputs["alignment_soft"] is not None:
        out["loss_binary_alignment"] = L.binary_alignment_loss(outputs["alignment_mas"],
                                                               outputs["alignment_soft"])
        loss = loss + config.binary_align_loss_alpha * out["loss_binary_alignment"] \
            * binary_loss_weight
    out["loss"] = loss
    return out


class ForwardTTS:
    """Host wrapper: tokenizer, speaker manager and weights around
    :class:`ForwardTTSModule`."""

    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: ForwardTTSConfig):
        check_supported(config)
        self.config = config
        self.args = config.model_args
        self.module = ForwardTTSModule(self.args).eval()  # dropouts act in training alone
        self.tokenizer: Optional[TTSTokenizer] = None
        self.speaker_manager = None
        self.language_manager = None
        self.initialized = False  # the trainer draws weights from config.seed until loaded
        self.binary_loss_weight = 1.0  # F61: set at each training step's start

    @classmethod
    def init_from_config(cls, config: ForwardTTSConfig) -> "ForwardTTS":
        """Tokenizer, speaker manager and model for ``config``: the top
        level's speaker fields mirrored into ``model_args``, the manager
        read from either (ROADMAP.md F24, F11); the embedding of the
        vocabulary's size when ``model_args.num_chars`` is ``None`` (a
        smaller one raises, F7). F27 is checked first."""
        check_supported(config)
        tokenizer, config = init_tokenizer(config)
        for f in _SPEAKER_FIELDS:
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
        return self.module.emb.weight.device

    @property
    def hop_length(self) -> int:
        return int(self.config.audio.hop_length)

    @property
    def uses_d_vectors(self) -> bool:
        """Whether speakers are given as d-vectors (``use_d_vector_file``)."""
        return bool(self.args.use_d_vector_file)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda",
                    discriminator: bool = False) -> "ForwardTTS":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: norm scales 1 and biases
        0; linear, conv and attention weights N(0, 1/fan_in); the token and
        speaker embeddings N(0, 1/hidden). The duration predictor's output
        is a tenth of its scale with the bias ``DURATION_BIAS`` of GlowTTS,
        so that a token lasts about 6 frames (LJSpeech's pace). The aligner's
        draws come last. ``discriminator`` is ignored (there is none)."""
        from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to("cpu")
        for name, p in module.named_parameters():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            fan_in = p[0].numel() if p.dim() > 1 else 1
            if isinstance(owner, (nn.LayerNorm, PositionalEncoding)):
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
        self.initialized = True
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra);
        the positional table follows them to their device."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.to(self.device).requires_grad_(False)
        self.initialized = True

    def load_checkpoint(self, config: ForwardTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "ForwardTTS":
        """Weights from a file: the port's state_dict of
        :class:`ForwardTTSModule` (``model_torch.pt``, or a trainer
        checkpoint's ``"model"``) or a reference-layout checkpoint
        (``model_file.pth`` or ``model.pth``; its aligner is kept, its
        positional table dropped). A file without the aligner's weights
        leaves the module's own there (inference does not run it).
        ``checkpoint_dir`` looks for those names in turn."""
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
        own = self.module.state_dict()
        state = {**{k: v for k, v in own.items() if k.startswith("aligner.")},
                 **self.port_state(state)}
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    def port_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``state`` in the port's layout: as it is when it holds the
        module's names (the aligner's aside), else converted from the
        reference layout, its aligner kept (what ``load_checkpoint`` and the
        trainer's ``--restore_path`` read)."""
        if set(state) >= {k for k in self.module.state_dict() if not k.startswith("aligner.")}:
            return state
        from tts_tpu_torch.utils.convert import load_reference_forward_tts

        return load_reference_forward_tts(state, self.args)

    # ------------------------------------------------------------------
    def on_train_step_start(self, trainer) -> None:
        """F61: the binary alignment loss's weight, ``min(epochs_done /
        binary_loss_warmup_epochs, 1)`` (reference ``forward_tts.py``
        ``on_train_step_start``); a resumed run restores ``epochs_done``, so
        it weighs as an uninterrupted one."""
        warmup = getattr(self.config, "binary_loss_warmup_epochs", 0) or 0
        self.binary_loss_weight = min(trainer.epochs_done / warmup, 1.0) if warmup > 0 else 1.0

    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   train: bool = True):
        """``(loss, metrics)`` of the teacher-forced pass on ``batch`` (the
        trainer's keys on the device): the losses of
        :func:`forward_tts_loss` and the outputs under ``"outputs"``. With
        ``train`` the dropouts draw from ``generator``; without it the
        module runs in eval mode."""
        module = self.module
        module.train(train)
        use_dropout_generator(module, generator if train else None)
        try:
            outputs = module(
                batch["text_input"], batch["text_lengths"], batch["mel_lengths"],
                batch["mel_input"], dr=batch.get("durations"), pitch=batch.get("pitch"),
                energy=batch.get("energy"), attn_priors=batch.get("attn_priors"),
                aux_input={"d_vectors": batch.get("d_vectors"),
                           "speaker_ids": batch.get("speaker_ids")})
        finally:
            use_dropout_generator(module, None)
        losses = forward_tts_loss(self.config, outputs, batch, self.binary_loss_weight)
        return losses["loss"], {**losses, "outputs": outputs}

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_frames: int = 1000,
                  aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Text ids → mel (:meth:`ForwardTTSModule.inference`); ``aux_input``
        holds ``speaker_ids [B]`` or ``d_vectors [B, C]`` on the model's
        device."""
        return self.module.inference(x, x_lengths, aux_input=aux_input, max_frames=max_frames)
