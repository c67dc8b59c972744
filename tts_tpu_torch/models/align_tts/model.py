"""AlignTTS text → mel inference (port of ``tts_tpu/models/align_tts/model.py:49-163``
and the wrapper ``:196-236``, reference ``TTS/tts/models/align_tts.py``):
token embedding, the encoder (``fftransformer`` or ``residual_conv_bn``
blocks of ``layers.feed_forward``), ``mod_layer`` and the duration
predictor, durations rounded to frames (at least one a token, times
``length_scale``), expansion through the monotonic path
(``generate_path``), positional encoding, the decoder and ``proj``.
``AlignTTS`` is the host wrapper (tokenizer, weights).

The decode runs at a frame budget (``max_frames``): ``y_lengths`` is cut
there, as in the JAX package.

Training (``tts_tpu/models/align_tts/model.py:25-47,83-151,166-193,238-241``):
the MDN head (``mdn_conv1``, ``mdn_norm``, ``mdn_conv2`` and its dropout,
built after the inference layers so that their draws in ``init_params``
stay as they were) gives each token a diagonal Gaussian over the mel;
``compute_log_probs`` scores every (token, frame) pair, MAS
(``ops.mas.maximum_path``, K2 on CUDA) finds the durations that the
decoder expands by and the duration predictor learns, and ``mdn_loss``
sums over every monotonic alignment: a plain loop over the frames, each
step one vectorised log-add over the tokens (the JAX ``lax.scan``'s
recursion). ``align_tts_loss`` weighs the MDN, spectral, SSIM and duration
losses by the training phase. Divergences, each named in its test:

* F62, settled in the port: the JAX step always trains in phase -1, its
  ``phase_start_steps`` unread; the port sets the phase at each epoch's
  start from ``phase_start_steps`` and the steps done, as the reference's
  ``_set_phase`` does (``None``, the recipe's setting, keeps -1).
* F64, kept as the JAX package has it: ``mod_layer``'s only output feeds
  the duration predictor through a detach, so its gradient is zero (only
  weight decay moves it), here as in the JAX package and the reference.

The JAX package has no
reference-layout converter for AlignTTS, so the port loads its own
checkpoint (``model_torch.pt``) and the JAX package's parameters
(``utils.convert.align_tts_from_jax_params``), and nothing more.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers import losses as L
from tts_tpu_torch.layers.common import Dropout, DurationPredictor, use_dropout_generator
from tts_tpu_torch.layers.feed_forward import (
    FLAX_LAYER_NORM_EPS,
    FFTransformerBlock,
    PositionalEncoding,
    ResidualConv1dBNBlock,
)
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
from tts_tpu_torch.ops.mas import maximum_path
from tts_tpu_torch.text.tokenizer import TTSTokenizer

from .config import AlignTTSArgs, AlignTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of AlignTTSModule


def _make_block(kind: str, channels: int, params: dict) -> nn.Module:
    """The JAX package's ``_make_block`` (``:49-66``): its defaults are 2
    heads, where ForwardTTS's are 1."""
    if kind == "fftransformer":
        return FFTransformerBlock(channels, params.get("num_heads", 2),
                                  params.get("hidden_channels_ffn", 1024),
                                  params.get("num_layers", 6), params.get("dropout_p", 0.1))
    return ResidualConv1dBNBlock(channels, channels, params.get("kernel_size", 4),
                                 tuple(params.get("dilations", [1, 2, 4] * 4 + [1])),
                                 params.get("num_conv_blocks", 2))


def mdn_loss(logp: torch.Tensor, text_lengths, mel_lengths) -> torch.Tensor:
    """The negative log-likelihood summed over every monotonic alignment
    (reference ``losses.py:540`` MDNLoss): ``logp [B, T_en, T_de]`` of
    each (token, frame), the log-domain recursion over the frames with the
    JAX package's -1e4 floor and 1e-4 offsets; frames past a sample's
    length leave its row as it was. Divided by the padded token count, as
    the JAX package divides."""
    B, T_en, T_de = logp.shape
    neg = -1e4
    alpha = F.pad(logp[:, :1, 0], (0, T_en - 1), value=neg)
    frames = logp.permute(2, 0, 1)  # [T_de, B, T_en]
    active = (torch.arange(1, T_de, device=logp.device)[:, None] < mel_lengths[None, :])[..., None]
    for t in range(1, T_de):
        prev = F.pad(alpha[:, :-1], (1, 0), value=neg)
        step = torch.logaddexp(alpha + 1e-4, prev + 1e-4) + frames[t]
        alpha = torch.where(active[t - 1], step, alpha)
    final = torch.gather(alpha, 1, (text_lengths.long() - 1)[:, None])[:, 0]
    return -final.mean() / T_en


class AlignTTSModule(nn.Module):
    """The AlignTTS network with its MDN head."""

    def __init__(self, args: AlignTTSArgs):
        super().__init__()
        a = self.args = args
        self.emb = nn.Embedding(a.num_chars, a.hidden_channels)
        self.pos_encoder = PositionalEncoding(a.hidden_channels)
        self.encoder = _make_block(a.encoder_type, a.hidden_channels, a.encoder_params)
        self.decoder = _make_block(a.decoder_type, a.hidden_channels, a.decoder_params)
        self.duration_predictor = DurationPredictor(a.hidden_channels, a.hidden_channels_dp, 3,
                                                    dropout_p=0.1)
        self.mod_layer = nn.Linear(a.hidden_channels, a.hidden_channels)
        self.proj = nn.Linear(a.hidden_channels, a.out_channels)
        self.mdn_conv1 = nn.Linear(a.hidden_channels, a.hidden_channels)
        self.mdn_norm = nn.LayerNorm(a.hidden_channels, eps=FLAX_LAYER_NORM_EPS)
        self.mdn_conv2 = nn.Linear(a.hidden_channels, 2 * a.out_channels)
        self.mdn_dropout = Dropout(0.1)

    def _encode(self, x, x_lengths):
        """The encoder output, ``mod_layer`` of it (the duration predictor's
        input) and the token mask."""
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].float()
        o_en = self.encoder(self.emb(x) * x_mask, x_mask)
        return o_en, self.mod_layer(o_en) * x_mask, x_mask

    def _decode(self, o_en, dr, x_mask, y_mask):
        """Expansion by ``dr``, positions, the decoder and ``proj``: the mel
        and the path ``[B, T_de, T_en]``."""
        attn = generate_path(dr, x_mask * y_mask.transpose(1, 2))
        o_en_ex = self.pos_encoder(torch.einsum("bxy,bxc->byc", attn, o_en), y_mask)
        return self.proj(self.decoder(o_en_ex, y_mask)) * y_mask, attn.transpose(1, 2)

    def _mdn(self, o_en):
        """Each token's Gaussian: ``(mu, log_sigma)``, ``[B, T_en, C_mel]``."""
        h = self.mdn_dropout(F.relu(self.mdn_norm(self.mdn_conv1(o_en))))
        return self.mdn_conv2(h).chunk(2, dim=-1)

    @staticmethod
    def compute_log_probs(mu, log_sigma, y):
        """The Gaussian log-likelihood of every frame of ``y [B, T_de, D]``
        under every token's ``(mu, log_sigma) [B, T_en, D]``, the squared
        term averaged over the mel channels (reference ``align_tts.py:150``):
        ``[B, T_en, T_de]``, its square expanded into three products as the
        JAX package expands it."""
        inv_var = torch.exp(-2.0 * log_sigma)
        t1 = torch.einsum("bxd,byd->bxy", mu**2 * inv_var, torch.ones_like(y))
        t2 = -2.0 * torch.einsum("bxd,byd->bxy", mu * inv_var, y)
        t3 = torch.einsum("bxd,byd->bxy", inv_var, y**2)
        return -0.5 * (t1 + t2 + t3) / mu.shape[-1] - 0.5 * log_sigma.mean(dim=-1)[:, :, None]

    def forward(self, x, x_lengths, y, y_lengths, phase: int = -1) -> Dict[str, Any]:
        """The training pass: token ids ``[B, T_en]`` and the mel ``y [B,
        T_de, C]``; ``phase`` 1 feeds the decoder the encoder detached."""
        o_en, o_en_dp, x_mask = self._encode(x, x_lengths)
        y_mask = sequence_mask(y_lengths, y.shape[1])[:, :, None].to(y.dtype)
        mu, log_sigma = self._mdn(o_en)
        logp = self.compute_log_probs(mu, log_sigma, y)
        attn_mas = maximum_path(logp.detach(), x_mask * y_mask.transpose(1, 2))
        dr_mas = attn_mas.sum(dim=-1)
        o_dr_log = self.duration_predictor(o_en_dp.detach(), x_mask)[..., 0]
        o_de, attn = self._decode(o_en.detach() if phase == 1 else o_en, dr_mas, x_mask, y_mask)
        return {"model_outputs": o_de, "alignments": attn, "durations_log": o_dr_log,
                "durations_mas_log": torch.log1p(dr_mas), "mu": mu, "log_sigma": log_sigma,
                "logp": logp, "x_mask": x_mask, "y_mask": y_mask}

    def durations(self, x, x_lengths):
        """The encoder output ``[B, T_en, C]``, the token mask and the frames
        a token ``[B, T_en]``: ``round((exp(log_dur) - 1) · length_scale)``
        of the predictor on ``mod_layer`` of the encoder, at least 1 for a
        valid token, 0 for padding."""
        o_en, o_en_dp, x_mask = self._encode(x, x_lengths)
        o_dr_log = self.duration_predictor(o_en_dp, x_mask)[..., 0]
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
        o_de, attn = self._decode(o_en, o_dr, x_mask, y_mask)
        return {"model_outputs": o_de, "alignments": attn, "durations": o_dr,
                "y_lengths": y_lengths, "y_mask": y_mask}


_PHASE_WEIGHTS = {0: (1.0, 0.0, 0.0, 0.0), 1: (0.0, 1.0, 1.0, 0.0), 2: (1.0, 1.0, 1.0, 0.0),
                  3: (0.0, 0.0, 0.0, 1.0)}


def align_tts_loss(config: AlignTTSConfig, outputs: Dict[str, Any], batch: Dict,
                   phase: int = -1) -> Dict[str, torch.Tensor]:
    """The MDN, spectral (MSE), SSIM and duration losses weighed by the
    phase: 0 the MDN alone, 1 the spectral and SSIM, 2 these three, 3 the
    durations alone, -1 the config's alphas (reference ``losses.py:564``
    AlignTTSLoss)."""
    mel, mel_lens, text_lens = batch["mel_input"], batch["mel_lengths"], batch["text_lengths"]
    l_mdn = mdn_loss(outputs["logp"], text_lens, mel_lens)
    l_spec = L.mse_loss_masked(outputs["model_outputs"], mel, mel_lens)
    l_ssim = L.ssim_loss(outputs["model_outputs"], mel, mel_lens)
    l_dur = L.mse_loss_masked(outputs["durations_log"][:, :, None],
                              outputs["durations_mas_log"][:, :, None], text_lens)
    w_mdn, w_spec, w_ssim, w_dur = _PHASE_WEIGHTS.get(phase, (
        config.mdn_alpha, config.spec_loss_alpha, config.ssim_alpha, config.dur_loss_alpha))
    return {"loss": w_mdn * l_mdn + w_spec * l_spec + w_ssim * l_ssim + w_dur * l_dur,
            "loss_mdn": l_mdn, "loss_spec": l_spec, "loss_ssim": l_ssim, "loss_dur": l_dur}


def training_phase(phase_start_steps, global_step: int) -> int:
    """F62: the phase whose start step the run has passed last (the
    reference's ``_set_phase``): 0 before the first, -1 without a list."""
    if not isinstance(phase_start_steps, (list, tuple)):
        return -1
    passed = [start < global_step for start in phase_start_steps]
    if True not in passed:
        return 0
    return len(passed) - passed[::-1].index(True) - 1


class AlignTTS:
    """Host wrapper: tokenizer and weights around :class:`AlignTTSModule`."""

    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: AlignTTSConfig):
        self.config = config
        self.args = config.model_args
        self.module = AlignTTSModule(self.args).eval()  # dropouts act in training alone
        self.tokenizer: Optional[TTSTokenizer] = None
        self.initialized = False  # the trainer draws weights from config.seed until loaded
        self.phase = -1  # F62: set at each epoch's start from phase_start_steps

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
    def init_params(self, seed: int = 0, device="cuda",
                    discriminator: bool = False) -> "AlignTTS":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: norm scales 1 and biases
        0; linear, conv and attention weights N(0, 1/fan_in); the token
        embedding N(0, 1/hidden). The duration predictor's output is a tenth
        of its scale with the bias ``DURATION_BIAS`` of GlowTTS, so that a
        token lasts about 6 frames (LJSpeech's pace). The MDN head's draws
        come last; ``discriminator`` is ignored (there is none)."""
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
        self.initialized = True
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra);
        the positional table follows them to their device."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.to(self.device).requires_grad_(False)
        self.initialized = True

    def load_checkpoint(self, config: AlignTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda") -> "AlignTTS":
        """Weights from the port's state_dict of :class:`AlignTTSModule`
        (``model_torch.pt`` in ``checkpoint_dir``, or ``checkpoint_path``, a
        trainer checkpoint's ``"model"`` too); a file without the MDN
        head's weights leaves the module's own there (inference does not
        run it). A reference-layout checkpoint raises: neither package
        converts one (ROADMAP.md item 16)."""
        device = resolve_device(device)
        if checkpoint_path is None:
            checkpoint_path = os.path.join(checkpoint_dir, PORT_WEIGHTS)
            if not os.path.isfile(checkpoint_path):
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS})")
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        own = self.module.state_dict()
        state = {**{k: v for k, v in own.items() if k.startswith("mdn_")}, **state}
        if not set(state) >= set(own):
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

    # ------------------------------------------------------------------
    def on_epoch_start(self, trainer) -> None:
        """F62: the phase from ``phase_start_steps`` and the steps done
        (reference ``align_tts.py`` ``on_epoch_start``); a resumed run
        restores the step count, so it trains in the phase an uninterrupted
        one would."""
        self.phase = training_phase(getattr(self.config, "phase_start_steps", None),
                                    trainer.global_step)

    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   train: bool = True):
        """``(loss, metrics)`` of the training pass in ``self.phase``: the
        losses of :func:`align_tts_loss` and the outputs under
        ``"outputs"``. With ``train`` the dropouts draw from ``generator``;
        without it the module runs in eval mode."""
        module = self.module
        module.train(train)
        use_dropout_generator(module, generator if train else None)
        try:
            outputs = module(batch["text_input"], batch["text_lengths"], batch["mel_input"],
                             batch["mel_lengths"], phase=self.phase)
        finally:
            use_dropout_generator(module, None)
        losses = align_tts_loss(self.config, outputs, batch, self.phase)
        return losses["loss"], {**losses, "outputs": outputs}
