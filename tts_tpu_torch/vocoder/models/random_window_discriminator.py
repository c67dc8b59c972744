"""The random window discriminator of GAN-TTS (port of
``tts_tpu/vocoder/models/random_window_discriminator.py``; arXiv:1909.11646,
reference ``TTS/vocoder/models/random_window_discriminator.py:137``).

Five unconditional discriminators score a random window of the waveform
each, and, given the mel, five conditional ones score a random window of
the waveform together with the mel frames under it. Each window is folded
into ``window / (2 hop)`` channels, so every discriminator runs at the same
base rate. A waveform ``[B, T, 1]`` (or ``[B, T]``) and the mel ``[B,
frames, cond_channels]`` in; ``(scores, [])`` out, each score ``[B, 1]``.

The window offsets (one a window, shared by the batch's rows, as in the JAX
module) come from an explicit ``torch.Generator`` or are passed in
(``offsets``: the unconditional windows' starts in samples, then the
conditional ones' in frames). The JAX GAN step gives this module neither
its ``windows`` stream nor the mel, so it raises there and its conditional
half never runs (ROADMAP.md F56); the port's GAN step draws the offsets
from the step's generator and passes the mel.

Module names follow the flax modules' (``uncond_<i>``, ``cond_<i>``,
``in_block``, ``down_<i>``, ``pre_<i>``, ``post_<i>``, ``cond_block``,
``residual``, ``conv1``, ``conv2``, ``start``, ``lc_conv1d``, ``end``,
``out``), so ``utils.convert.flax_to_state_dict`` maps the JAX parameters
one to one. The convolutions run on ``[B, C, T]``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["RandomWindowDiscriminator"]


def _avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C, T]`` → ``[B, C, T // factor]``: the mean of each run of
    ``factor`` samples, a remainder dropped."""
    if factor <= 1:
        return x
    B, C, T = x.shape
    T2 = (T // factor) * factor
    return x[:, :, :T2].reshape(B, C, T2 // factor, factor).mean(dim=3)


class _DBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, downsample_factor: int = 1):
        super().__init__()
        self.factor = downsample_factor
        self.residual = nn.Conv1d(in_channels, out_channels, 1)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=2, dilation=2)

    def forward(self, x):
        h = _avg_pool(x, self.factor)
        r = self.residual(h)
        h = self.conv1(F.relu(h))
        h = self.conv2(F.relu(h))
        return h + r


class _GBlock(nn.Module):
    """The conditioning's entry: the mel added after the first convolution."""

    def __init__(self, in_channels: int, cond_channels: int, downsample_factor: int):
        super().__init__()
        out_ch = in_channels * 2
        self.factor = downsample_factor
        self.start = nn.Conv1d(in_channels, out_ch, 3, padding=1)
        self.lc_conv1d = nn.Conv1d(cond_channels, out_ch, 1)
        self.end = nn.Conv1d(out_ch, out_ch, 3, padding=2, dilation=2)
        self.residual = nn.Conv1d(in_channels, out_ch, 1)

    def forward(self, x, c):
        h = _avg_pool(x, self.factor)
        h = self.start(F.relu(h))
        h = h + self.lc_conv1d(c)
        h = self.end(F.relu(h))
        return h + _avg_pool(self.residual(x), self.factor)


class _UnconditionalD(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 64,
                 downsample_factors: Tuple[int, ...] = (8, 4),
                 out_channels: Tuple[int, ...] = (128, 256)):
        super().__init__()
        self.in_block = _DBlock(in_channels, base_channels, 1)
        ch = base_channels
        self.n_down = len(downsample_factors)
        for i, f in enumerate(downsample_factors):
            self.add_module(f"down_{i}", _DBlock(ch, out_channels[i], f))
            ch = out_channels[i]
        self.post_0 = _DBlock(ch, ch, 1)
        self.post_1 = _DBlock(ch, ch, 1)
        self.out = nn.Conv1d(ch, 1, 1)

    def forward(self, x):
        h = self.in_block(x)
        for i in range(self.n_down):
            h = getattr(self, f"down_{i}")(h)
        h = self.post_1(self.post_0(h))
        return self.out(h.mean(dim=2, keepdim=True))


class _ConditionalD(nn.Module):
    def __init__(self, in_channels: int, cond_channels: int,
                 downsample_factors: Tuple[int, ...] = (2, 2, 2),
                 out_channels: Tuple[int, ...] = (128, 256)):
        super().__init__()
        self.pre_0 = _DBlock(in_channels, 64, 1)
        ch = 64
        self.n_pre = len(out_channels)
        for i, co in enumerate(out_channels):
            self.add_module(f"pre_{i + 1}", _DBlock(ch, co, downsample_factors[i]))
            ch = co
        self.cond_block = _GBlock(ch, cond_channels, downsample_factors[-1])
        ch *= 2
        self.post_0 = _DBlock(ch, ch, 1)
        self.post_1 = _DBlock(ch, ch, 1)
        self.out = nn.Conv1d(ch, 1, 1)

    def forward(self, x, c):
        h = self.pre_0(x)
        for i in range(self.n_pre):
            h = getattr(self, f"pre_{i + 1}")(h)
        h = self.cond_block(h, c)
        h = self.post_1(self.post_0(h))
        return self.out(h.mean(dim=2, keepdim=True))


class RandomWindowDiscriminator(nn.Module):
    """Waveform ``[B, T, 1]`` and mel ``[B, frames, cond_channels]`` →
    ``(scores, [])`` like the other discriminators."""

    def __init__(self, cond_channels: int = 80, hop_length: int = 256,
                 uncond_disc_downsample_factors: Tuple[int, ...] = (8, 4),
                 uncond_disc_out_channels: Tuple[int, ...] = (128, 256),
                 cond_disc_downsample_factors: Sequence[Tuple[int, ...]] = (
                     (8, 4, 2, 2, 2), (8, 4, 2, 2), (8, 4, 2), (8, 4), (4, 2, 2)),
                 cond_disc_out_channels: Sequence[Tuple[int, ...]] = (
                     (128, 128, 256, 256), (128, 256, 256), (128, 256), (256,), (128, 256)),
                 window_sizes: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192)):
        super().__init__()
        self.hop_length = hop_length
        self.window_sizes = tuple(window_sizes)
        self.ks = [ws // (hop_length * 2) for ws in self.window_sizes]
        for i, k in enumerate(self.ks):
            self.add_module(f"uncond_{i}", _UnconditionalD(
                k, downsample_factors=tuple(uncond_disc_downsample_factors),
                out_channels=tuple(uncond_disc_out_channels)))
        for i, k in enumerate(self.ks):
            self.add_module(f"cond_{i}", _ConditionalD(
                k, cond_channels, tuple(cond_disc_downsample_factors[i]),
                tuple(cond_disc_out_channels[i])))

    def draw_offsets(self, T: int, frames: Optional[int],
                     generator: torch.Generator) -> Tuple[list, list]:
        """Each window's start, uniform as ``jax.random.randint(0, max(1, n -
        size))``: in samples for the unconditional windows, in frames for the
        conditional ones (none without a mel). Drawn on the generator's
        device, brought to the host."""
        def draw(high):
            return int(torch.randint(0, max(1, high), (), generator=generator,
                                     device=generator.device))
        uncond = [draw(T - ws) for ws in self.window_sizes]
        cond = [] if frames is None else [draw(frames - ws // self.hop_length)
                                          for ws in self.window_sizes]
        return uncond, cond

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                offsets: Optional[Tuple[list, list]] = None):
        if x.dim() == 2:
            x = x[:, :, None]
        B, T, _ = x.shape
        if offsets is None:
            if generator is None:
                raise ValueError("the random window discriminator needs its window offsets or "
                                 "a generator to draw them from")
            offsets = self.draw_offsets(T, None if c is None else c.shape[1], generator)
        uncond, cond = offsets
        wav = x[..., 0]
        scores = []
        for i, (ws, k) in enumerate(zip(self.window_sizes, self.ks)):
            start = min(max(uncond[i], 0), max(T - ws, 0))  # dynamic_slice clamps so
            win = wav[:, start:start + ws].reshape(B, ws // k, k).transpose(1, 2)
            scores.append(getattr(self, f"uncond_{i}")(win))
        if c is not None:
            frames = c.shape[1]
            for i, (ws, k) in enumerate(zip(self.window_sizes, self.ks)):
                size = ws // self.hop_length
                lc = min(max(cond[i], 0), max(frames - size, 0))
                c_sub = c[:, lc:lc + size].transpose(1, 2)
                s0 = min(lc * self.hop_length, max(T - size * self.hop_length, 0))
                x_sub = wav[:, s0:s0 + size * self.hop_length].reshape(B, ws // k, k)
                scores.append(getattr(self, f"cond_{i}")(x_sub.transpose(1, 2), c_sub))
        return [s[:, :, 0] for s in scores], []
