"""Tortoise: an autoregressive GPT over mel codes, then a diffusion mel
decoder and the bundled UnivNet (port of
``tts_tpu/models/tortoise/model.py``, reference ``TTS/tts/models/tortoise.py:309``
and ``layers/tortoise/{autoregressive,diffusion_decoder,clvp}.py``).

Stages: reference audio → conditioning latents (or the random-voice latent
generators); text → k candidate code sequences from ``UnifiedVoice`` on the
port's KV-cached ``GPT2Core``, whose every decode step launches the
decode-attention kernel once a layer on CUDA; CLVP picks the best candidate
(or the longest, without CLVP); a teacher-forced pass over the chosen codes
gives the latents; the diffusion decoder turns them into a mel (DDIM or
DPM-Solver++(2M), classifier-free guidance as two decoder calls a step);
the UnivNet turns the mel into 24 kHz audio.

PyTorch runs eagerly: the JAX package's ``lax.scan`` loops are Python loops
here, and the AR loop reads its done flags every ``DONE_CHECK_EVERY`` steps
to stop once every candidate has emitted its stop token. Differences from
the JAX package, each named in a test:

* **F45.** The latents are cut exactly where ``trim_index_at_calm`` finds
  the end of speech, as the reference does (``models/tortoise.py:783-790``).
  The JAX package rounds the cut up to a 32-code bucket against XLA
  recompiles (``tts_tpu/models/tortoise/model.py:571-575``), which leaves
  up to 31 codes, about 1.4 s, of extra audio on every utterance.
* **F47.** A candidate holding a code past CLVP's speech vocabulary (the
  AR start token, which random weights sample) is never chosen: its score
  is ``-inf``. In the JAX package its embedding is NaN, and ``np.argmax``
  takes the first NaN score.

Every Gaussian draw (the diffusion's initial noise, the vocoder's noise,
the random-voice draws) goes through :func:`normal`, so that tests can
hand both packages the same draws.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device
from tts_tpu_torch.models.xtts.gpt_core import GPT2Core, sample_logits
from tts_tpu_torch.vocoder.models.univnet_generator import UnivnetGenerator

from .audio import (
    denormalize_tacotron_mel,
    format_conditioning,
    pad_or_truncate,
    wav_to_univnet_mel,
)
from .config import TortoiseConfig
from .layers import CLVP, AttentionBlock, DiffusionTts
from .tokenizer import VoiceBpeTokenizer

CALM_TOKEN = 83  # mel code for silence (reference models/tortoise.py:712)
LOG_MEL_PAD = -11.512925  # log(1e-5): the silence frame fed to the vocoder
DONE_CHECK_EVERY = 8  # AR decode steps between reads of the done flags


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draw of ``shape`` from ``generator``, on its device."""
    return torch.randn(shape, generator=generator, device=generator.device)


def fix_autoregressive_codes(codes: np.ndarray, stop_token: int,
                             calm_token: int = CALM_TOKEN) -> np.ndarray:
    """The AR outputs' tails recoded as the DVAE expects (reference
    ``models/tortoise.py:89 fix_autoregressive_output``): from the first stop
    token on, the calm (silence) code, and the last three codes the DVAE's
    padding suffix (45, 45, 248). ``[B, T]`` → ``[B, T]``."""
    codes = np.array(codes)
    # reduced widths: the DVAE's codes must stay inside the vocabulary
    suffix = np.minimum([45, 45, 248], stop_token - 1)
    calm_token = min(calm_token, stop_token - 1)
    is_stop = codes == stop_token
    any_stop = is_stop.any(axis=1)
    first_stop = np.where(any_stop, is_stop.argmax(axis=1), codes.shape[1])
    tail = np.arange(codes.shape[1])[None, :] >= first_stop[:, None]
    codes = np.where(tail, calm_token, codes)
    codes[any_stop, -3:] = suffix
    return codes


def trim_index_at_calm(codes_row: np.ndarray, calm_token: int = CALM_TOKEN,
                       breathing_room: int = 8) -> int:
    """Position of the first code where more than ``breathing_room``
    consecutive calm codes have accumulated (reference
    ``models/tortoise.py:783-790``): the end of speech."""
    calm = np.asarray(codes_row) == calm_token
    run = 0
    for i, c in enumerate(calm):
        run = run + 1 if c else 0
        if run > breathing_room:
            return i
    return len(calm)


def random_latent_converter_apply(state: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The reference ``RandomLatentConverter``'s inference
    (``random_latent_generator.py:39``) on the standard normal draw ``x [1,
    channels]``: five EqualLinear layers (``lr_mul`` 0.1, scaled weights,
    leaky ReLU times sqrt 2), then a plain Linear."""
    lr_mul = 0.1
    for i in range(5):
        w, b = state[f"layers.{i}.weight"], state[f"layers.{i}.bias"]
        scale = (1.0 / math.sqrt(w.shape[1])) * lr_mul
        x = F.leaky_relu(x @ (w * scale).T + b * lr_mul, 0.2) * math.sqrt(2.0)
    return x @ state["layers.5.weight"].T + state["layers.5.bias"]


class TortoiseConditioningEncoder(nn.Module):
    """Reference ``autoregressive.ConditioningEncoder``: a 1x1 conv in, then
    attention blocks; the conditioning latent is the first position."""

    def __init__(self, embedding_dim: int, attn_blocks: int = 6, num_attn_heads: int = 16):
        super().__init__()
        self.init = nn.Linear(80, embedding_dim)
        self.attn = nn.ModuleList([AttentionBlock(embedding_dim, num_attn_heads)
                                   for _ in range(attn_blocks)])

    def forward(self, x):  # [B, T, 80] → [B, T, D]
        h = self.init(x).transpose(1, 2)
        for block in self.attn:
            h = block(h)
        return h.transpose(1, 2)


class UnifiedVoice(nn.Module):
    """The AR decoder over discrete mel codes (reference
    ``autoregressive.py:262``) on the port's ``GPT2Core``: HF GPT-2 blocks
    with biases and the tanh gelu, ``ln_f``, then the model's own
    ``final_norm``, as the JAX package's defaults have it."""

    def __init__(self, layers: int = 30, model_dim: int = 1024, heads: int = 16,
                 number_text_tokens: int = 255, number_mel_codes: int = 8194,
                 start_mel_token: int = 8192, stop_mel_token: int = 8193,
                 start_text_token: int = 255, stop_text_token: int = 0,
                 max_text_tokens: int = 402, max_mel_tokens: int = 604,
                 max_conditioning_inputs: int = 1):
        super().__init__()
        D = model_dim
        self.number_mel_codes = number_mel_codes
        self.start_mel_token, self.stop_mel_token = start_mel_token, stop_mel_token
        self.start_text_token, self.stop_text_token = start_text_token, stop_text_token
        self.conditioning_encoder = TortoiseConditioningEncoder(D, 6, heads)
        self.text_embedding = nn.Embedding(number_text_tokens + 1, D)
        self.mel_embedding = nn.Embedding(number_mel_codes, D)
        self.text_pos_embedding = nn.Parameter(torch.empty(max_text_tokens + 2, D))
        # reference build_hf_gpt_transformer: + max_conditioning_inputs
        self.mel_pos_embedding = nn.Parameter(
            torch.empty(max_mel_tokens + 2 + max_conditioning_inputs, D))
        self.gpt = GPT2Core(layers=layers, dim=D, heads=heads)
        self.final_norm = nn.LayerNorm(D, eps=1e-5)
        self.text_head = nn.Linear(D, number_text_tokens + 1)
        self.mel_head = nn.Linear(D, number_mel_codes)
        self.decode_steps = 0  # decode steps run, for the launch count

    def get_conditioning(self, cond_mels: torch.Tensor) -> torch.Tensor:
        """``[B, T, 80]`` → one conditioning latent ``[B, 1, D]``."""
        return self.conditioning_encoder(cond_mels)[:, :1]

    def _embed_text(self, text_tokens: torch.Tensor) -> torch.Tensor:
        B = text_tokens.shape[0]
        text = torch.cat([text_tokens.new_full((B, 1), self.start_text_token), text_tokens,
                          text_tokens.new_full((B, 1), self.stop_text_token)], dim=1)
        return self.text_embedding(text) + self.text_pos_embedding[None, : text.shape[1]]

    def _mel_pos(self, start: int, length: int) -> torch.Tensor:
        # the JAX package's dynamic_slice would clamp past the table
        if start + length > self.mel_pos_embedding.shape[0]:
            raise ValueError(f"mel positions {start}..{start + length - 1} pass the "
                             f"{self.mel_pos_embedding.shape[0]}-row position table")
        return self.mel_pos_embedding[start : start + length]

    def forward(self, cond_latent: torch.Tensor, text_tokens: torch.Tensor,
                mel_codes: torch.Tensor):
        """Teacher-forced forward → ``(text_logits, mel_logits, mel_latents)``.
        The conditioning position's hidden state is dropped (reference
        ``autoregressive.py:419``), so each segment covers its whole token
        count, start and stop tokens included."""
        B = text_tokens.shape[0]
        mel = torch.cat([mel_codes.new_full((B, 1), self.start_mel_token), mel_codes,
                         mel_codes.new_full((B, 1), self.stop_mel_token)], dim=1)
        te = self._embed_text(text_tokens)
        me = self.mel_embedding(mel) + self._mel_pos(0, mel.shape[1])[None]
        h = self.gpt(torch.cat([cond_latent, te, me], dim=1), causal=True)
        h = self.final_norm(h[:, 1:])
        T_t = te.shape[1]
        mel_latents = h[:, T_t:]
        return self.text_head(h[:, :T_t]), self.mel_head(mel_latents), mel_latents

    @torch.no_grad()
    def generate(self, cond_latent: torch.Tensor, text_tokens: torch.Tensor,
                 generator: Optional[torch.Generator] = None, max_new_tokens: int = 500,
                 temperature: float = 0.8, top_p: float = 0.8,
                 repetition_penalty: float = 2.0) -> Dict[str, torch.Tensor]:
        """KV-cached sampling of mel codes: ``codes [B, max_new_tokens]``
        (stop tokens after each row's end), ``lengths [B]`` and the latent
        that predicted each code ``latents [B, steps, D]``. Generated code k
        takes mel position k + 1 (the start token has 0). The loop stops
        once every row is done (read every ``DONE_CHECK_EVERY`` steps); the
        codes are then filled with stop tokens, and the latents cover the
        steps run."""
        B = text_tokens.shape[0]
        start = self.mel_embedding(text_tokens.new_full((B, 1), self.start_mel_token))
        prefix = torch.cat([cond_latent, self._embed_text(text_tokens),
                            start + self._mel_pos(0, 1)[None]], dim=1)
        L_pre = prefix.shape[1]
        cache = self.gpt.init_cache(B, L_pre + max_new_tokens, prefix.dtype, prefix.device)
        h = self.final_norm(self.gpt(prefix, causal=True, cache=cache, cache_index=0))[:, -1]
        logits = self.mel_head(h)
        dev = prefix.device
        rep = torch.zeros((B, self.number_mel_codes), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n = torch.zeros((B,), dtype=torch.int32, device=dev)
        toks, lats = [], []
        for step in range(max_new_tokens):
            tok = sample_logits(logits, generator, temperature=temperature, top_k=0,
                                top_p=top_p, repetition_counts=rep,
                                repetition_penalty=repetition_penalty)
            tok = torch.where(done, self.stop_mel_token, tok)
            done = done | (tok == self.stop_mel_token)
            n = n + (~done).to(torch.int32)
            rep = rep.scatter_add(1, tok[:, None], torch.ones_like(rep[:, :1]))
            toks.append(tok)
            lats.append(h)
            emb = self.mel_embedding(tok)[:, None] + self._mel_pos(step + 1, 1)[None]
            cur = L_pre + step
            h = self.final_norm(self.gpt(emb, cache=cache, cache_index=cur,
                                         cache_len=cur + 1))[:, -1]
            logits = self.mel_head(h)
            self.decode_steps += 1
            if (step + 1) % DONE_CHECK_EVERY == 0 and step + 1 < max_new_tokens \
                    and bool(done.all()):
                break
        codes = torch.stack(toks, dim=1)
        if codes.shape[1] < max_new_tokens:
            codes = F.pad(codes, (0, max_new_tokens - codes.shape[1]), value=self.stop_mel_token)
        return {"codes": codes, "latents": torch.stack(lats, dim=1), "lengths": n}


# ----------------------------------------------------------------------
# diffusion samplers
# ----------------------------------------------------------------------


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32 as XLA evaluates it on the CPU
    (``start * (1 - t) + stop * t`` with ``t = i * (1 / (num - 1))``), so
    that the schedule and the step times are the JAX package's (a float64
    linspace would give other integer step times, 2666 where the JAX
    package's 4-step schedule has 2665)."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = torch.tensor(num - 1, dtype=torch.float32)
    t = torch.arange(num - 1, dtype=torch.float32) * (1 / div)
    start_, stop_ = (torch.tensor(v, dtype=torch.float32) for v in (start, stop))
    out = start_ * (1 - t) + stop_ * t
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


def _schedule(trained_steps: int, steps: int):
    """``(abar [trained_steps], step times [steps])``: the linear schedule
    of betas scaled from the 1000-step [1e-4, 2e-2] range, in float32 on the
    host, and the step times from ``trained_steps - 1`` down to 0."""
    scale = 1000.0 / trained_steps
    betas = _linspace_f32(1e-4 * scale, 2e-2 * scale, trained_steps)
    abar = torch.cumprod(1 - betas, dim=0)
    ts = _linspace_f32(trained_steps - 1, 0, steps).to(torch.int32).tolist()
    return abar, ts


def _eps_fn(decoder, embeddings, in_channels, cond_free, cond_free_k):
    def eps(x, t: int):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        out = decoder(x, t_vec, precomputed_embeddings=embeddings)[..., :in_channels]
        if cond_free:  # the second half of the output is the learned variance
            free = decoder(x, t_vec, precomputed_embeddings=embeddings,
                           conditioning_free=True)[..., :in_channels]
            out = (1 + cond_free_k) * out - cond_free_k * free
        return out
    return eps


def _initial_noise(embeddings, T_mel, in_channels, generator, temperature, noise):
    if noise is None:
        noise = normal((embeddings.shape[0], T_mel, in_channels), generator)
    return noise.to(embeddings) * temperature


@torch.no_grad()
def ddim_sample(decoder, embeddings: torch.Tensor, T_mel: int,
                generator: Optional[torch.Generator] = None, steps: int = 30,
                in_channels: int = 100, temperature: float = 1.0, cond_free: bool = True,
                cond_free_k: float = 2.0, trained_steps: int = 4000,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM over ``DiffusionTts`` (the JAX package's
    replacement of the reference's respaced p-sample loop): ``steps``
    updates from ``trained_steps - 1`` down to 0, the clean estimate clipped
    to [-1, 1]; ``cond_free`` guides with ``cond_free_k``. ``noise [B,
    T_mel, in_channels]`` is the initial draw (else drawn from
    ``generator``), times ``temperature``."""
    abar, ts = _schedule(trained_steps, steps)
    eps_fn = _eps_fn(decoder, embeddings, in_channels, cond_free, cond_free_k)
    x = _initial_noise(embeddings, T_mel, in_channels, generator, temperature, noise)
    one = torch.tensor(1.0)
    for i, t in enumerate(ts):
        a_t = abar[t]
        a_next = abar[ts[i + 1]] if i + 1 < steps else one
        eps = eps_fn(x, t)
        x0 = torch.clamp((x - torch.sqrt(1 - a_t).item() * eps) / torch.sqrt(a_t).item(), -1.0, 1.0)
        x = torch.sqrt(a_next).item() * x0 + torch.sqrt(1 - a_next).item() * eps
    return x


@torch.no_grad()
def dpm_solver_sample(decoder, embeddings: torch.Tensor, T_mel: int,
                      generator: Optional[torch.Generator] = None, steps: int = 10,
                      in_channels: int = 100, temperature: float = 1.0, cond_free: bool = True,
                      cond_free_k: float = 2.0, trained_steps: int = 4000,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al., arXiv:2211.01095), the JAX package's
    reduction of the reference's vendored ``dpm_solver.py`` to the
    multistep data-prediction update: the same schedule and guidance as
    :func:`ddim_sample`; the last step emits the clean estimate."""
    abar, ts = _schedule(trained_steps, steps)
    eps_fn = _eps_fn(decoder, embeddings, in_channels, cond_free, cond_free_k)
    x = _initial_noise(embeddings, T_mel, in_channels, generator, temperature, noise)

    def lam(t):
        return 0.5 * (torch.log(abar[t]) - torch.log1p(-abar[t]))

    x0_prev, h_prev = torch.zeros_like(x), torch.tensor(0.0)
    for i, t in enumerate(ts):
        t_next = ts[min(i + 1, steps - 1)]
        a = abar[t]
        x0 = torch.clamp((x - torch.sqrt(1 - a).item() * eps_fn(x, t)) / torch.sqrt(a).item(),
                         -1.0, 1.0)
        h = lam(t_next) - lam(t)
        if i > 0 and h.item() != 0:  # 2M: extrapolate with the previous x0
            r = h_prev / h
            D = x0 + (x0 - x0_prev) / (2.0 * (r.item() if r.item() != 0 else 1.0))
        else:
            D = x0
        if i == steps - 1:
            x_new = x0
        else:
            sg_next, sg_cur = torch.sqrt(1 - abar[t_next]), torch.sqrt(1 - a)
            x_new = (sg_next / sg_cur).item() * x - (torch.sqrt(abar[t_next])
                                                     * torch.expm1(-h)).item() * D
        x, x0_prev, h_prev = x_new, x0, h
    return x


SAMPLERS = {"ddim": ddim_sample, "dpm++2m": dpm_solver_sample}


class Tortoise(nn.Module):
    """The host pipeline (reference ``models/tortoise.py:309``). CLVP and
    the vocoder are built when their weights load (``clvp2.pth``,
    ``vocoder.pth``) or by :meth:`init_params`; without CLVP the longest
    candidate is kept, and without the vocoder ``inference`` returns the
    mel alone."""

    # quality and speed presets (reference ``tortoise.py:556``): they fill
    # what the call leaves unset
    PRESETS = {
        "single_sample": {"num_autoregressive_samples": 8, "diffusion_iterations": 10,
                          "sampler": "ddim"},
        "ultra_fast": {"num_autoregressive_samples": 16, "diffusion_iterations": 10,
                       "sampler": "ddim"},
        "ultra_fast_old": {"num_autoregressive_samples": 16, "diffusion_iterations": 30,
                           "cond_free": False},
        "very_fast": {"num_autoregressive_samples": 32, "diffusion_iterations": 30,
                      "sampler": "dpm++2m"},
        "fast": {"num_autoregressive_samples": 5, "diffusion_iterations": 50,
                 "sampler": "ddim"},
        "fast_old": {"num_autoregressive_samples": 96, "diffusion_iterations": 80},
        "standard": {"num_autoregressive_samples": 5, "diffusion_iterations": 200},
        "high_quality": {"num_autoregressive_samples": 256, "diffusion_iterations": 400},
    }

    def __init__(self, config: TortoiseConfig):
        super().__init__()
        self.config = config
        a = self.args = config.model_args
        self.autoregressive = UnifiedVoice(
            layers=a.ar_layers, model_dim=a.ar_model_dim, heads=a.ar_heads,
            number_text_tokens=a.ar_number_text_tokens, number_mel_codes=a.ar_number_mel_codes,
            start_mel_token=a.ar_start_mel_token, stop_mel_token=a.ar_stop_mel_token,
            start_text_token=a.ar_start_text_token, stop_text_token=a.ar_stop_text_token,
            max_text_tokens=a.ar_max_text_tokens, max_mel_tokens=a.ar_max_mel_tokens,
        )
        self.diffusion = DiffusionTts(
            model_channels=a.diff_model_channels, num_layers=a.diff_num_layers,
            in_channels=a.diff_in_channels, in_latent_channels=a.diff_in_latent_channels,
            out_channels=a.diff_out_channels, num_heads=a.diff_num_heads,
        )
        self.clvp: Optional[CLVP] = None
        self.vocoder: Optional[UnivnetGenerator] = None
        self.tokenizer = VoiceBpeTokenizer()
        self.mel_norms: Optional[torch.Tensor] = None  # the AR conditioning mel's norms
        self.rlg_auto: Optional[Dict[str, torch.Tensor]] = None  # random-voice generators
        self.rlg_diffuser: Optional[Dict[str, torch.Tensor]] = None
        self.output_sample_rate = config.audio.output_sample_rate

    @classmethod
    def init_from_config(cls, config: TortoiseConfig):
        return cls(config)

    @property
    def device(self) -> torch.device:
        return self.autoregressive.mel_pos_embedding.device

    def build_vocoder(self) -> UnivnetGenerator:
        """The bundled UnivNet variant (reference ``tortoise/vocoder.py:277``)."""
        a = self.args
        return UnivnetGenerator(
            in_channels=a.voc_noise_dim, hidden_channels=a.voc_channel_size, cond_channels=100,
            upsample_factors=tuple(a.voc_strides), pad_mode="reflect", kpnet_lrelu_slope=0.2,
            final_lrelu_slope=0.2, kpnet_residual_style="per_block")

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", dtype=torch.float32,
                    clvp: bool = True, vocoder: bool = True) -> "Tortoise":
        """Random weights from ``seed``, drawn on ``device`` by a generator of
        that device (a CPU draw is the same on every machine; a card's differs
        from it), then cast to ``dtype``: norm scales 1 and biases 0, linear
        and conv weights N(0, 1/fan_in), embeddings, position tables and the
        unconditioned embedding N(0, 0.02²), relative-position tables
        N(0, 0.02²), CLVP's temperature 1. CLVP (at its defaults) and the
        vocoder are built unless told not to."""
        device = resolve_device(device)
        if clvp:
            self.clvp = CLVP()
        if vocoder:
            self.vocoder = self.build_vocoder()
        self.to(device)
        gen = torch.Generator(device).manual_seed(seed)
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if isinstance(module, (nn.LayerNorm, nn.GroupNorm)) or name == "g":
                    p.fill_(1.0 if name in ("weight", "g") else 0.0)
                elif name == "bias":
                    p.zero_()
                elif name == "temperature":
                    p.fill_(1.0)
                elif isinstance(module, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
                    fan_in = p[0].numel() if not isinstance(module, nn.ConvTranspose1d) else (
                        p.shape[0] * p.shape[2])
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) / fan_in**0.5)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
        return self.requires_grad_(False).to(device=device, dtype=dtype)

    def load_checkpoint(self, config=None, checkpoint_dir: str = None, device="cuda", **kwargs):
        """A model directory in the reference's tortoise-v2 layout
        (:func:`load_tortoise_checkpoint`)."""
        return load_tortoise_checkpoint(self, checkpoint_dir, device=device)

    def quantize_weights_int8(self, compute_dtype: Optional[torch.dtype] = None) -> None:
        """Store the ``UnifiedVoice`` AR stack's matmul and convolution
        weights of at least 4096 elements as int8 with per-output-channel
        scales (``ops/quant.py``), in place, the float weights freed: its
        conditioning encoder (1x1 convolutions, dequantized once a voice),
        the GPT core and the heads (through K4). CLVP and the diffusion
        decoder stay float, as in the JAX package (``ar_params`` only)."""
        from tts_tpu_torch.ops.quant import install_int8

        install_int8(self, ("autoregressive",), compute_dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rerank(self, text_tokens: torch.Tensor, candidate_codes: torch.Tensor) -> torch.Tensor:
        """CLVP scores ``[k]`` of k candidate code sequences for one text
        ``[T]``; a candidate holding a code past CLVP's speech vocabulary
        scores ``-inf`` (F47)."""
        k = candidate_codes.shape[0]
        vocab = self.clvp.speech_emb.num_embeddings
        valid = (candidate_codes < vocab).all(dim=1)
        text = text_tokens.reshape(1, -1).expand(k, -1)
        scores = self.clvp(text, torch.where(candidate_codes < vocab, candidate_codes, 0))
        return torch.where(valid, scores, float("-inf"))

    @torch.no_grad()
    def get_conditioning_latents(self, voice_samples):
        """Reference ``tortoise.py:405`` (averaging mode 0):
        ``voice_samples`` is a list of ``(wav_22050, wav_24000)`` numpy pairs
        → ``(auto_latent [1, 1, D], diffusion_latent [1, 2*MC])``, the mean
        of the clips' latents."""
        auto, diff = [], []
        dev = self.device
        for wav22, wav24 in voice_samples:
            cond = format_conditioning(wav22, mel_norms=self.mel_norms, device=dev)
            auto.append(self.autoregressive.get_conditioning(cond))
            clip = pad_or_truncate(np.asarray(wav24, np.float32).reshape(-1), 102400)
            mel = wav_to_univnet_mel(torch.from_numpy(clip)[None].to(dev))
            diff.append(self.diffusion.get_conditioning(mel))
        return torch.stack(auto).mean(dim=0), torch.stack(diff).mean(dim=0)

    @torch.no_grad()
    def get_random_conditioning_latents(self, generator: torch.Generator):
        """Random-voice latents through the reference's random latent
        generators (``tortoise.py:482``), or scaled normal draws where
        ``rlg_auto.pth`` and ``rlg_diffuser.pth`` are not loaded."""
        D = self.args.ar_model_dim
        MC2 = 2 * self.args.diff_model_channels
        dev = self.device
        if self.rlg_auto is not None and self.rlg_diffuser is not None:
            auto = random_latent_converter_apply(self.rlg_auto, normal((1, D), generator).to(dev))
            diff = random_latent_converter_apply(self.rlg_diffuser,
                                                 normal((1, MC2), generator).to(dev))
            return auto[:, None, :], diff
        return (normal((1, 1, D), generator).to(dev) * 0.02,
                normal((1, MC2), generator).to(dev) * 0.02)

    @torch.no_grad()
    def inference(self, text_tokens, cond_mels: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, max_mel_tokens: int = 100,
                  diffusion_iterations: Optional[int] = None,
                  auto_latent: Optional[torch.Tensor] = None,
                  diffusion_latent: Optional[torch.Tensor] = None,
                  diffusion_cond_mels: Optional[torch.Tensor] = None,
                  num_samples: int = 1, vocode: bool = True, sampler: Optional[str] = None,
                  cond_free: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Text tokens ``[B, T]`` and the voice's conditioning → the mel
        ``[B, T_mel, 100]`` (denormalised), and the 24 kHz wav where the
        vocoder is loaded (reference ``tortoise.py:599``). The voice is given
        as latents (``auto_latent [1, 1, D]``, ``diffusion_latent [1, 2*MC]``)
        or mels (``cond_mels [B, T, 80]`` in the tacotron domain,
        ``diffusion_cond_mels [B, T, 100]`` in the univnet domain).
        ``num_samples`` > 1 draws that many candidates for one text and keeps
        CLVP's best (or the longest). ``generator`` (seeded 0 on the model's
        device by default) draws the AR samples, then the diffusion's noise,
        then the vocoder's."""
        a = self.args
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        text_tokens = torch.as_tensor(text_tokens, device=dev).long()
        if auto_latent is None:
            if cond_mels is None:
                raise ValueError("pass auto_latent or cond_mels")
            auto_latent = self.autoregressive.get_conditioning(cond_mels.to(dev))
        if diffusion_latent is None:
            if diffusion_cond_mels is None:
                raise ValueError(
                    "pass diffusion_latent or diffusion_cond_mels (univnet-domain, reference "
                    "tortoise.py:446): 80-channel AR mels are not a valid substitute")
            diffusion_latent = self.diffusion.get_conditioning(diffusion_cond_mels.to(dev))
        B = text_tokens.shape[0]
        k = max(1, num_samples)
        if k > 1 and B > 1:
            raise ValueError(f"num_samples > 1 (CLVP best-of-k) supports batch size 1; got B={B}"
                             " — run utterances separately")
        gen = self.autoregressive.generate(
            auto_latent.repeat_interleave(k, dim=0), text_tokens.repeat_interleave(k, dim=0),
            generator, max_new_tokens=max_mel_tokens, temperature=a.temperature,
            top_p=a.top_p, repetition_penalty=a.repetition_penalty)
        codes = gen["codes"].cpu().numpy()
        lengths = gen["lengths"]
        if k > 1:
            fixed = torch.from_numpy(fix_autoregressive_codes(codes, a.ar_stop_mel_token)).to(dev)
            scores = (self.rerank(text_tokens[0], fixed) if self.clvp is not None
                      else lengths.float())
            best = int(torch.argmax(scores))
            codes, lengths = codes[best][None], lengths[best][None]
        codes = fix_autoregressive_codes(codes, a.ar_stop_mel_token)

        # a teacher-forced pass over the fixed codes gives the diffusion's
        # latents (reference tortoise.py:761 return_latent=True), without
        # the start and stop positions
        latents = self.autoregressive(auto_latent, text_tokens,
                                      torch.from_numpy(codes).to(dev))[2][:, :-2]
        # F45: cut exactly at the end of speech, as the reference does
        calm = min(CALM_TOKEN, a.ar_stop_mel_token - 1)
        n_keep = max(1, trim_index_at_calm(codes[0], calm_token=calm))
        latents = latents[:, :n_keep]
        # 22.05 kHz code frames → 24 kHz output frames (tortoise.py:132)
        T_mel = n_keep * 4 * 24000 // 22050
        sample = SAMPLERS.get(sampler if sampler is not None else a.sampler, ddim_sample)
        emb = self.diffusion.timestep_independent(latents, diffusion_latent, T_mel)
        mel = sample(self.diffusion, emb, T_mel, generator,
                     steps=diffusion_iterations or a.diffusion_iterations,
                     in_channels=a.diff_in_channels, temperature=a.diffusion_temperature,
                     cond_free=a.cond_free if cond_free is None else cond_free,
                     cond_free_k=a.cond_free_k)
        out = {"mel": denormalize_tacotron_mel(mel), "codes": torch.from_numpy(codes),
               "code_lengths": lengths}
        if vocode and self.vocoder is not None:
            out["wav"] = self.vocode(out["mel"], generator)
        return out

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Denormalised log-mel ``[B, T, 100]`` → wav ``[B, T * hop]``
        through the bundled UnivNet (reference ``tortoise/vocoder.py:363``:
        10 silence frames appended against edge artifacts, cut after)."""
        B, T, C = mel.shape
        melp = torch.cat([mel, mel.new_full((B, 10, C), LOG_MEL_PAD)], dim=1)
        noise = normal((B, T + 10, self.args.voc_noise_dim), generator).to(mel)
        wav = self.vocoder(melp, noise)[..., 0]
        hop = int(np.prod(self.args.voc_strides))
        return torch.clamp(wav[:, : hop * T], -1.0, 1.0)

    def synthesize(self, text: str, config=None, speaker_id: Optional[str] = None,
                   speaker_wav=None, voice_dirs=None, language=None,
                   generator: Optional[torch.Generator] = None, **kwargs):
        """Text → speech (reference ``tortoise.py:503``): the voice from
        reference wavs (``speaker_wav``), from ``voice_dirs/<speaker_id>/*.wav``,
        or the random-voice generators (``speaker_id`` ``"random"`` or none).
        ``kwargs`` take a ``preset``, ``seed`` (of the generator, 0 by
        default), ``max_mel_tokens`` (500), ``diffusion_iterations``,
        ``num_autoregressive_samples``, ``sampler`` and ``cond_free``.
        Returns ``{"wav": [T] at 24 kHz, "text_inputs", "conditioning_latents"}``."""
        from tts_tpu_torch.audio.numpy_transforms import load_wav

        a = self.args
        seed = int(kwargs.pop("seed", 0))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        preset = kwargs.pop("preset", None)
        if preset is not None:
            if preset not in self.PRESETS:
                raise ValueError(f"unknown tortoise preset {preset!r}; known: "
                                 f"{sorted(self.PRESETS)}")
            for key, value in self.PRESETS[preset].items():
                kwargs.setdefault(key, value)
        wav_paths = []
        if speaker_wav is not None:
            wav_paths = [speaker_wav] if isinstance(speaker_wav, str) else list(speaker_wav)
        elif voice_dirs is not None and speaker_id not in (None, "random"):
            dirs = [voice_dirs] if isinstance(voice_dirs, str) else list(voice_dirs)
            for d in dirs:
                wav_paths += sorted(glob.glob(os.path.join(d, speaker_id, "*.wav")))
            if not wav_paths:
                raise ValueError(f"no reference wavs for voice {speaker_id!r} in {dirs}")
        elif speaker_id not in (None, "random"):
            raise ValueError(
                f"speaker {speaker_id!r} requested but no speaker_wav or voice_dirs given — "
                "pass voice_dirs (reference voice folders) or use speaker_id='random'")
        if wav_paths:
            samples = [(load_wav(filename=p, sample_rate=22050, resample=True),
                        load_wav(filename=p, sample_rate=24000, resample=True))
                       for p in wav_paths]
            auto_latent, diffusion_latent = self.get_conditioning_latents(samples)
        else:
            auto_latent, diffusion_latent = self.get_random_conditioning_latents(generator)

        ids = self.tokenizer.encode(text) + [a.ar_stop_text_token]  # reference tortoise.py:677
        if len(ids) >= 400:
            raise ValueError("Too much text for one Tortoise pass; split into sentences "
                             f"(got {len(ids)} tokens, reference cap 400)")
        out = self.inference(
            torch.tensor([ids], dtype=torch.int64), generator=generator,
            auto_latent=auto_latent, diffusion_latent=diffusion_latent,
            max_mel_tokens=kwargs.pop("max_mel_tokens", 500),
            diffusion_iterations=kwargs.pop("diffusion_iterations", a.diffusion_iterations),
            num_samples=kwargs.pop("num_autoregressive_samples", a.num_autoregressive_samples),
            sampler=kwargs.pop("sampler", None), cond_free=kwargs.pop("cond_free", None))
        if "wav" not in out:
            raise RuntimeError("tortoise vocoder weights not loaded (vocoder.pth missing from "
                               "the checkpoint dir)")
        return {"wav": out["wav"][0].float().cpu().numpy(), "text_inputs": ids,
                "conditioning_latents": (auto_latent, diffusion_latent)}


def load_tortoise_checkpoint(model: Tortoise, checkpoint_dir: str, device="cuda") -> Tortoise:
    """The reference tortoise-v2 directory (``autoregressive.pth``,
    ``diffusion_decoder.pth``, ``clvp2.pth``, ``vocoder.pth``,
    ``mel_norms.pth``, ``rlg_auto.pth``, ``rlg_diffuser.pth``), each file
    converted as it is read (reference ``models/tortoise.py load_checkpoint``;
    the JAX package converts each to a flax ``.msgpack`` once). The AR model
    and the diffusion decoder must be there; CLVP, the vocoder, the norms and
    the random-voice generators are optional."""
    from tts_tpu_torch.utils import convert as C

    device = resolve_device(device)
    a = model.args
    path = lambda name: os.path.join(checkpoint_dir, name)  # noqa: E731

    def read(name):
        state = torch.load(path(name), map_location="cpu", weights_only=True)
        state = state.get("model_g", state)  # vocoder.pth holds its generator there
        return {k: C._to_numpy(v) for k, v in state.items()}

    def assign(module, state):
        module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True,
                               assign=True)
        module.requires_grad_(False)

    for name in ("autoregressive.pth", "diffusion_decoder.pth"):
        if not os.path.isfile(path(name)):
            raise FileNotFoundError(f"No {name} in {checkpoint_dir} (the tortoise-v2 layout)")
    assign(model.autoregressive, C.flax_to_state_dict(
        C.convert_unified_voice(read("autoregressive.pth"), layers=a.ar_layers)))
    assign(model.diffusion, C.flax_to_state_dict(
        C.convert_diffusion_decoder(read("diffusion_decoder.pth"),
                                    num_layers=a.diff_num_layers)))
    if os.path.isfile(path("clvp2.pth")):
        state = read("clvp2.pth")
        with torch.device("meta"):
            model.clvp = CLVP()
        assign(model.clvp, C.flax_to_state_dict(C.convert_clvp(state)))
    if os.path.isfile(path("vocoder.pth")):
        state = C.convert_tortoise_univnet(read("vocoder.pth"),
                                           num_blocks=len(a.voc_strides))
        with torch.device("meta"):
            model.vocoder = model.build_vocoder()
        assign(model.vocoder, C.univnet_from_jax_params(state))
    if os.path.isfile(path("mel_norms.pth")):
        loaded = torch.load(path("mel_norms.pth"), map_location="cpu", weights_only=True)
        if isinstance(loaded, dict):
            loaded = next(iter(loaded.values()))
        model.mel_norms = torch.as_tensor(loaded, dtype=torch.float32).to(device)
    for attr, name in (("rlg_auto", "rlg_auto.pth"), ("rlg_diffuser", "rlg_diffuser.pth")):
        if os.path.isfile(path(name)):
            setattr(model, attr, {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                                  for k, v in read(name).items()})
    return model
