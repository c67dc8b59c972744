"""WaveGrad, the diffusion vocoder (port of ``tts_tpu/vocoder/models/wavegrad.py``,
reference ``TTS/vocoder/models/wavegrad.py`` and ``layers/wavegrad.py``):
``_interp_nearest``, ``FiLM``, ``UBlock``, ``DBlock`` and ``Wavegrad``
(``:19-132``), ``compute_noise_schedule`` (``:135-146``),
``wavegrad_train_loss`` and ``WavegradVocoder`` (``:149-205``, the training
wrapper) and ``wavegrad_inference`` (``:208-235``).

``Wavegrad`` predicts the noise in a noisy waveform from the mel and the
noise level: a downsampling branch over the waveform gives each level a FiLM
shift and scale, an upsampling branch over the mel takes them.
``wavegrad_inference`` runs the reverse diffusion as a Python loop over the
schedule's steps (the JAX package's ``lax.scan``); the first ``y`` and each
step's ``z`` come from an explicit ``torch.Generator`` or from ``noise``.

Public layout is the JAX package's: waveform ``[B, T_wav, 1]``, mel ``[B,
T_mel, M]``, noise level ``[B]``; the network runs on ``[B, C, T]`` inside.
Module and parameter names follow the flax modules', so
``utils.convert.flax_to_state_dict`` maps the JAX parameters one to one. The
FiLM positional table is built as the JAX module builds it (``arange(T) /
div`` in float32, sine and cosine of arguments up to ``T``) and cached per
length and device.

Training denoises: a random step ``s`` of the train schedule, a noise level
uniform between its two bounds, the waveform corrupted at that level, the
network's predicted noise held to the drawn noise by L1. The three draws
come from the step's ``torch.Generator`` (``WavegradVocoder.draw``), or
are given; the trainer's generic step runs ``WavegradVocoder.train_step``.
``bin/tune_wavegrad.py`` searches the inference schedule.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import init_weights, noise_generator, pointwise


def _interp_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, C, T]`` → ``[B, C, size]``, nearest (torch ``F.interpolate``'s
    default), the source index computed in float32 as in the JAX package,
    on ``x``'s device (an index made on the host and copied would hold the
    host until the device has caught up)."""
    idx = (torch.arange(size, dtype=torch.float32, device=x.device) * (x.shape[2] / size)).long()
    return x[:, :, idx]


def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k - 1) // 2 * dilation)


class FiLM(nn.Module):
    """Noise-level conditioned shift and scale, each ``[B, output_size, T]``,
    from the waveform branch's ``[B, C, T]``."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_conv = _conv(input_size, input_size, 3)
        self.output_conv = _conv(input_size, output_size * 2, 3)
        self._tables = {}

    def positional_table(self, T: int, device) -> torch.Tensor:
        """``[C, T]``: sines and cosines of the positions ``arange(T)`` over
        ``10000 ** (2i / C)``, interleaved along the channels, float32."""
        key = (T, str(device))
        if key not in self._tables:
            C = self.input_conv.out_channels
            div = torch.pow(10000.0, torch.arange(0, C, 2, dtype=torch.float32) / C)
            pos = torch.arange(T, dtype=torch.float32)[:, None] / div[None, :]
            pe = torch.zeros(T, C)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(pos), torch.cos(pos)
            self._tables[key] = pe.t().contiguous().to(device)
        return self._tables[key]

    def forward(self, x: torch.Tensor, noise_level: torch.Tensor):
        o = F.leaky_relu(self.input_conv(x), 0.2)
        o = o + noise_level[:, None, None] + self.positional_table(o.shape[2], o.device) / 5000.0
        return self.output_conv(o).chunk(2, dim=1)


class UBlock(nn.Module):
    """Upsample by ``factor`` (nearest), four dilated convs under the FiLM
    shift and scale, a 1x1 residual projection."""

    def __init__(self, input_size: int, hidden_size: int, factor: int,
                 dilation: Sequence[int]):
        super().__init__()
        self.factor = factor
        self.res_block = nn.Linear(input_size, hidden_size)
        self.main_0 = _conv(input_size, hidden_size, 3, dilation[0])
        self.main_1 = _conv(hidden_size, hidden_size, 3, dilation[1])
        self.out_0 = _conv(hidden_size, hidden_size, 3, dilation[2])
        self.out_1 = _conv(hidden_size, hidden_size, 3, dilation[3])

    def forward(self, x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        size = x.shape[2] * self.factor
        res = pointwise(self.res_block, _interp_nearest(x, size))
        o = self.main_0(_interp_nearest(F.leaky_relu(x, 0.2), size))
        o = self.main_1(F.leaky_relu(shift + scale * o, 0.2))
        res2 = res + o
        o = self.out_0(F.leaky_relu(shift + scale * res2, 0.2))
        o = self.out_1(F.leaky_relu(shift + scale * o, 0.2))
        return o + res2


class DBlock(nn.Module):
    """Downsample by ``factor`` (nearest), three dilated convs, a 1x1
    residual projection."""

    def __init__(self, input_size: int, hidden_size: int, factor: int):
        super().__init__()
        self.factor = factor
        self.res_block = nn.Linear(input_size, hidden_size)
        self.main_0 = _conv(input_size, hidden_size, 3, 1)
        self.main_1 = _conv(hidden_size, hidden_size, 3, 2)
        self.main_2 = _conv(hidden_size, hidden_size, 3, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[2] // self.factor
        res = _interp_nearest(pointwise(self.res_block, x), size)
        o = _interp_nearest(x, size)
        for conv in (self.main_0, self.main_1, self.main_2):
            o = conv(F.leaky_relu(o, 0.2))
        return o + res


class Wavegrad(nn.Module):
    """Noisy waveform ``[B, T_wav, 1]``, mel ``[B, T_mel, M]`` and noise
    level ``[B]`` → predicted noise ``[B, T_wav, 1]``,
    ``T_wav = T_mel * prod(upsample_factors)``."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1, y_conv_channels: int = 32,
                 x_conv_channels: int = 768,
                 dblock_out_channels: Sequence[int] = (128, 128, 256, 512),
                 ublock_out_channels: Sequence[int] = (512, 512, 256, 128, 128),
                 upsample_factors: Sequence[int] = (4, 4, 4, 2, 2),
                 upsample_dilations: Sequence[Sequence[int]] = (
                     (1, 2, 1, 2), (1, 2, 1, 2), (1, 2, 4, 8), (1, 2, 4, 8), (1, 2, 4, 8))):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.hop = int(np.prod(self.upsample_factors))
        ublocks, dblocks = tuple(ublock_out_channels), tuple(dblock_out_channels)
        self.y_conv = _conv(1, y_conv_channels, 5)
        self.film_0 = FiLM(y_conv_channels, ublocks[-1])
        down = tuple(zip(dblocks, tuple(reversed(self.upsample_factors))[:-1]))
        up = tuple(zip(ublocks, self.upsample_factors, upsample_dilations))
        self.num_dblocks, self.num_ublocks = len(down), len(up)
        ic = y_conv_channels
        for i, (oc, f) in enumerate(down):
            self.add_module(f"dblock_{i}", DBlock(ic, oc, f))
            film_out = tuple(reversed(ublocks))[i + 1] if i + 1 < len(ublocks) else oc
            self.add_module(f"film_{i + 1}", FiLM(oc, film_out))
            ic = oc
        self.x_conv = _conv(in_channels, x_conv_channels, 3)
        ic = x_conv_channels
        for i, (oc, f, dil) in enumerate(up):
            self.add_module(f"ublock_{i}", UBlock(ic, oc, f, tuple(dil)))
            ic = oc
        self.out_conv = _conv(ic, out_channels, 3)

    def film(self, x: torch.Tensor, noise_scale: torch.Tensor) -> list:
        """The waveform branch: each level's ``(shift, scale)``, finest first."""
        d = self.y_conv(x.transpose(1, 2))
        shift_and_scale = [self.film_0(d, noise_scale)]
        for i in range(self.num_dblocks):
            d = getattr(self, f"dblock_{i}")(d)
            shift_and_scale.append(getattr(self, f"film_{i + 1}")(d, noise_scale))
        return shift_and_scale

    def decode(self, spectrogram: torch.Tensor, shift_and_scale: list) -> torch.Tensor:
        """The mel branch under the FiLM parameters → ``[B, T_wav, 1]``."""
        o = self.x_conv(spectrogram.transpose(1, 2))
        for i in range(self.num_ublocks):
            shift, scale = shift_and_scale[len(shift_and_scale) - 1 - i]
            o = getattr(self, f"ublock_{i}")(o, shift, scale)
        return self.out_conv(o).transpose(1, 2)

    def forward(self, x: torch.Tensor, spectrogram: torch.Tensor,
                noise_scale: torch.Tensor) -> torch.Tensor:
        return self.decode(spectrogram, self.film(x, noise_scale))


def compute_noise_schedule(num_steps: int, min_val: float = 1e-6, max_val: float = 1e-2):
    """The β schedule → ``(β, α, ᾱ, noise levels)``, float64 numpy, the
    noise levels ``[1, sqrt(ᾱ_0), ..., sqrt(ᾱ_{n-1})]``."""
    beta = np.linspace(min_val, max_val, num_steps)
    alpha = 1 - beta
    alpha_hat = np.cumprod(alpha)
    noise_level = np.concatenate([[1.0], alpha_hat**0.5])
    return beta, alpha, alpha_hat, noise_level


@torch.no_grad()
def wavegrad_inference(model: Wavegrad, mel: torch.Tensor, schedule,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None, clip: bool = True) -> torch.Tensor:
    """Reverse diffusion over ``schedule`` (:func:`compute_noise_schedule`)
    from the mel ``[B, T_mel, M]`` → waveform ``[B, T_mel * hop, 1]``,
    clipped to ±1 unless ``clip`` is false. ``noise`` ``[num_steps + 1, B,
    T_wav, 1]`` holds the first ``y`` and then each step's ``z`` (the last
    step's is drawn and multiplied by 0, as in the JAX package); without it
    they are drawn from ``generator``, on its device. The schedule's
    constants are float32 scalars, as the JAX package's arrays are."""
    beta, alpha, alpha_hat, _ = (np.asarray(a, np.float32) for a in schedule)
    num_steps = len(beta)
    B, T_mel, _ = mel.shape
    shape = (B, T_mel * model.hop, 1)
    g = None if noise is not None else generator or noise_generator(mel.device)

    def draw(i):
        if noise is not None:
            return noise[i].to(mel)
        return torch.randn(shape, generator=g, device=g.device, dtype=mel.dtype).to(mel.device)

    y = draw(0)
    sqrt_alpha_hat = np.sqrt(alpha_hat)
    for n in range(num_steps):
        idx = num_steps - 1 - n
        nl = torch.full((B,), float(sqrt_alpha_hat[idx]), dtype=mel.dtype, device=mel.device)
        noise_hat = model(y, mel, nl)
        c1 = np.float32(1.0) / np.sqrt(alpha[idx])
        c2 = (np.float32(1.0) - alpha[idx]) / np.sqrt(np.float32(1.0) - alpha_hat[idx])
        y = float(c1) * (y - float(c2) * noise_hat)
        z = draw(n + 1)
        if idx > 0:
            sigma = np.sqrt((np.float32(1.0) - alpha_hat[idx - 1])
                            / (np.float32(1.0) - alpha_hat[idx]) * beta[idx])
            y = y + float(sigma) * z
    return torch.clamp(y, -1.0, 1.0) if clip else y


def wavegrad_train_loss(model: Wavegrad, batch: Dict[str, torch.Tensor], schedule,
                        draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The denoising L1 of one batch (port of ``wavegrad.py:149-162``):
    ``draws`` ``(s [B] steps in 1..n-1, u [B] uniforms, noise like the
    waveform)``, the noise level ``l_s + u (l_{s+1} - l_s)`` of the
    schedule's float32 levels. ``batch``: ``waveform [B, T, 1]``, ``mel [B,
    T / hop, M]``."""
    y, mel = batch["waveform"], batch["mel"]
    levels = torch.as_tensor(np.asarray(schedule[3], np.float32), device=y.device)
    s, u, noise = draws
    l_a, l_b = levels[s], levels[s + 1]
    nl = l_a + u * (l_b - l_a)
    noisy = nl[:, None, None] * y + torch.sqrt(1 - nl**2)[:, None, None] * noise
    noise_hat = model(noisy, mel, nl)
    return torch.mean(torch.abs(noise - noise_hat))


class WavegradVocoder:
    """WaveGrad's training wrapper (port of ``wavegrad.py:165-205``): the
    network (``module``), the train schedule, and the hooks of the trainer's
    generic single-optimizer step."""

    def __init__(self, config):
        import inspect

        self.config = config
        valid = set(inspect.signature(Wavegrad.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in (config.model_params or {}).items() if k in valid}
        kwargs.setdefault("in_channels", config.audio.num_mels)
        with torch.device("meta"):
            self.module = Wavegrad(**kwargs).eval()
        ns = config.train_noise_schedule
        self.schedule = compute_noise_schedule(ns["num_steps"], ns["min_val"], ns["max_val"])
        self.initialized = False

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", discriminator: bool = False):
        """Random fp32 weights from ``seed`` (``vocoder.layers.init_weights``),
        the head zero as the JAX module initialises it (the untrained model
        predicts no noise); ``discriminator`` is ignored (there is none)."""
        from tts_tpu_torch import resolve_device

        gen = torch.Generator().manual_seed(seed)
        module = init_weights(self.module.to_empty(device="cpu"), gen,
                              zero=("out_conv.weight", "out_conv.bias"))
        self.module = module.to(resolve_device(device)).requires_grad_(False)
        self.initialized = True
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)
        self.initialized = True

    def draw(self, y: torch.Tensor, generator: torch.Generator):
        """A step's draws for the waveform ``y`` ``[B, T, 1]``: ``(s, u,
        noise)`` from ``generator`` (on its device), moved to ``y``'s."""
        B, g = y.shape[0], generator
        s = torch.randint(1, len(self.schedule[0]), (B,), generator=g, device=g.device)
        u = torch.rand(B, generator=g, device=g.device)
        noise = torch.randn(y.shape, generator=g, device=g.device)
        return s.to(y.device), u.to(y), noise.to(y)

    def train_step(self, batch, generator: torch.Generator, train: bool = True):
        """``(loss, {"wavegrad_l1": loss})``; with ``train`` false the draws
        come from a generator seeded 0 on the batch's device (the JAX eval's
        fixed key)."""
        y = batch["waveform"]
        if not train:
            generator = torch.Generator(device=y.device).manual_seed(0)
        loss = wavegrad_train_loss(self.module, batch, self.schedule, self.draw(y, generator))
        return loss, {"wavegrad_l1": loss}

    def get_dataset(self, config, samples, is_eval: bool = False):
        from tts_tpu_torch.vocoder.dataset import GANDataset

        return GANDataset(config, samples, is_eval=is_eval)

    def format_batch(self, batch: dict) -> dict:
        return batch
