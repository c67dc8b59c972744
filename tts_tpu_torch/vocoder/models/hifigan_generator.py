"""HiFiGAN generator (port of ``tts_tpu/vocoder/models/hifigan_generator.py``).

Public layout is the JAX package's: ``[B, T, C]`` in, ``[B, T*prod(up), 1]``
out; the convolutions run on ``[B, C, T]`` inside. Upsampling uses
``nn.ConvTranspose1d`` directly, whose weight is ``[in, out, k]``; the JAX
package's ``TorchConvTranspose1d`` keeps a time-flipped ``[k, in, out]``
kernel, so ``utils.convert`` flips ``k`` when it maps one to the other.

``x_mask`` (``[B, T, 1]`` at input-frame resolution) is re-applied after
every conv, so masked gaps behave like zero padding, as in the JAX package.
``inference`` serves the generator as a stand-alone vocoder: the mel
padded with ``inference_padding`` (5) edge frames on each side.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def _conv1d(cin, cout, k, dilation=1, bias=True):
    """Length-preserving torch-style conv: padding ``(k*d - d)//2`` each side."""
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k * dilation - dilation) // 2,
                     bias=bias)


class ResBlock1(nn.Module):
    """3 × (dilated conv + plain conv) residual block."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([_conv1d(channels, channels, kernel_size, d) for d in dilations])
        self.convs2 = nn.ModuleList([_conv1d(channels, channels, kernel_size) for _ in dilations])

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            if x_mask is not None:
                xt = xt * x_mask
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
            if x_mask is not None:
                x = x * x_mask
        return x


class ResBlock2(nn.Module):
    """2 × dilated-conv residual block."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([_conv1d(channels, channels, kernel_size, d) for d in dilations])

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
            if x_mask is not None:
                x = x * x_mask
        return x


class HifiganGenerator(nn.Module):
    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        resblock_type: str = "1",
        resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        upsample_initial_channel: int = 512,
        upsample_factors: Sequence[int] = (8, 8, 2, 2),
        cond_channels: int = 0,
        conv_post_bias: bool = True,
        cond_in_each_up_layer: bool = False,
        inference_padding: int = 5,
    ):
        super().__init__()
        self.inference_padding = inference_padding
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_factors = tuple(upsample_factors)
        self.cond_in_each_up_layer = cond_in_each_up_layer
        resblock_cls = ResBlock1 if str(resblock_type) == "1" else ResBlock2
        ch0 = upsample_initial_channel
        self.conv_pre = _conv1d(in_channels, ch0, 7)
        if cond_channels > 0:
            self.cond_layer = nn.Linear(cond_channels, ch0)
        self.ups = nn.ModuleList()
        self.cond_up = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_factors, upsample_kernel_sizes)):
            cin, ch = ch0 // (2**i), ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, ch, k, stride=u, padding=(k - u) // 2))
            if cond_in_each_up_layer:
                self.cond_up.append(nn.Linear(cond_channels, ch))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = _conv1d(ch, out_channels, 7, bias=conv_post_bias)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, C_in]
        g: Optional[torch.Tensor] = None,  # [B, C_g] or [B, 1|T, C_g]
        x_mask: Optional[torch.Tensor] = None,  # [B, T, 1]
    ) -> torch.Tensor:
        o = self.conv_pre(x.transpose(1, 2))  # [B, C, T]
        if g is not None and g.dim() == 2:
            g = g[:, None, :]
        if hasattr(self, "cond_layer") and g is not None:
            o = o + self.cond_layer(g).transpose(1, 2)
        mask = x_mask.transpose(1, 2) if x_mask is not None else None
        if mask is not None:
            o = o * mask
        for i, (up, u) in enumerate(zip(self.ups, self.upsample_factors)):
            o = up(F.leaky_relu(o, LRELU_SLOPE))
            if self.cond_in_each_up_layer and g is not None:
                g_i = g
                if g.shape[1] not in (1, o.shape[2]):
                    # per-frame conditioning tracks the upsampled resolution
                    g_i = torch.repeat_interleave(g, o.shape[2] // g.shape[1], dim=1)
                o = o + self.cond_up[i](g_i).transpose(1, 2)
            if mask is not None:
                mask = torch.repeat_interleave(mask, u, dim=2)
                o = o * mask
            z_sum = None
            for j in range(self.num_kernels):
                z = self.resblocks[i * self.num_kernels + j](o, mask)
                z_sum = z if z_sum is None else z_sum + z
            o = z_sum / self.num_kernels
        # the final activation is leaky_relu's default 0.01 slope, not 0.1
        o = torch.tanh(self.conv_post(F.leaky_relu(o, 0.01)))
        if mask is not None:
            o = o * mask
        return o.transpose(1, 2)

    def inference(self, c: torch.Tensor) -> torch.Tensor:
        """A stand-alone vocoder's call: the mel ``[B, T, C]`` with
        ``inference_padding`` edge frames on each side."""
        p = self.inference_padding
        return self(F.pad(c.transpose(1, 2), (p, p), mode="replicate").transpose(1, 2))
