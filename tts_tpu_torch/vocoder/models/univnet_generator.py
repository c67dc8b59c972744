"""UnivNet generator (port of ``tts_tpu/vocoder/models/univnet_generator.py:22-195``,
reference ``TTS/vocoder/models/univnet_generator.py`` and
``layers/lvc_block.py``): ``KernelPredictor``,
``location_variable_convolution``, ``LVCBlock`` and ``UnivnetGenerator``,
inference only.

Each LVC block predicts, from the mel, one small convolution kernel per mel
frame and layer, and applies it to that frame's ``hop`` samples
(location-variable convolution). The windows are views of the padded signal,
one per tap: the sum over the ``K`` taps is ``K`` batched matrix products
over all frames at once, as the JAX package's ``einsum``s are.

Public layout is the JAX package's: mel ``[B, L, M]`` and noise
``[B, L, in_channels]`` in, ``[B, L * prod(upsample_factors), 1]`` out; the
convolutions run on ``[B, C, T]`` inside. Module and parameter names follow
the flax modules', so ``utils.convert.flax_to_state_dict`` maps the JAX
parameters one to one (each block's ``upsample`` flipped back into a
``ConvTranspose1d``). ``pad_mode``, the slopes and ``kpnet_residual_style``
keep the fields of the tortoise-bundled variant (reflect-padded edge
convolutions, 0.2 slopes, a residual add per block).

``inference(c)`` settles ROADMAP.md F31 for UnivNet: the JAX module has no
``inference``, so the JAX ``Synthesizer`` raises on this vocoder. Here it
draws ``[B, L, in_channels]`` noise from an explicit ``torch.Generator`` and
pads nothing (the JAX module has no padding field); ``forward(c, x)`` takes
the noise as given. The discriminator serves training and waits for it
(ROADMAP.md item 17).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import noise_generator


def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k - 1) // 2 * dilation)


class KernelPredictor(nn.Module):
    """Mel ``[B, C_cond, L]`` → per-frame kernels ``[B, L, conv_layers,
    C_in, C_out, K]`` and biases ``[B, L, conv_layers, C_out]``: an input
    conv, three residual pairs of convs, then the kernel and bias convs."""

    def __init__(self, cond_channels: int, conv_in_channels: int, conv_out_channels: int,
                 conv_layers: int, conv_kernel_size: int = 3, kpnet_hidden_channels: int = 64,
                 kpnet_conv_size: int = 3, lrelu_slope: float = 0.1,
                 residual_style: str = "shared"):
        super().__init__()
        self.shape = (conv_layers, conv_in_channels, conv_out_channels, conv_kernel_size)
        self.slope, self.residual_style = lrelu_slope, residual_style
        kh, k = kpnet_hidden_channels, kpnet_conv_size
        self.input_conv = _conv(cond_channels, kh, 5)
        for i in range(3):
            self.add_module(f"res_{i}a", _conv(kh, kh, k))
            self.add_module(f"res_{i}b", _conv(kh, kh, k))
        self.kernel_conv = _conv(kh, math.prod(self.shape), k)
        self.bias_conv = _conv(kh, conv_out_channels * conv_layers, k)

    def forward(self, c: torch.Tensor):
        s = self.slope
        h = F.leaky_relu(self.input_conv(c), s)
        r = h
        for i in range(3):
            r = F.leaky_relu(getattr(self, f"res_{i}a")(r), s)
            r = F.leaky_relu(getattr(self, f"res_{i}b")(r), s)
            if self.residual_style == "per_block":
                r = h + r
                h = r
        if self.residual_style != "per_block":
            h = h + r
        B, _, L = c.shape
        kernels = self.kernel_conv(h).transpose(1, 2).reshape(B, L, *self.shape)
        bias = self.bias_conv(h).transpose(1, 2).reshape(B, L, self.shape[0], self.shape[2])
        return kernels, bias


def location_variable_convolution(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                                  hop_size: int) -> torch.Tensor:
    """``x`` ``[B, T, C_in]`` (``T = L * hop_size``) convolved frame by frame
    with ``kernel`` ``[B, L, C_in, C_out, K]`` plus ``bias`` ``[B, L,
    C_out]`` → ``[B, T, C_out]``: frame ``l``'s samples see the zero-padded
    signal around them through frame ``l``'s own kernel (dilation 1)."""
    B, T, C_in = x.shape
    _, L, _, C_out, K = kernel.shape
    p = (K - 1) // 2
    xp = F.pad(x, (0, 0, p, p))
    o = 0.0
    for k in range(K):  # tap k of every frame: one batched product over all frames
        o = o + torch.matmul(xp[:, k : k + T].reshape(B, L, hop_size, C_in), kernel[..., k])
    return (o + bias[:, :, None, :]).reshape(B, T, C_out)


class LVCBlock(nn.Module):
    """Upsample ``x`` ``[B, C, T]`` by ``upsample_ratio`` (leaky ReLU, a
    transposed conv), then ``conv_layers`` gated residual layers: a dilated
    conv (dilation ``3**i``), then the location-variable convolution with
    the kernels predicted from the mel ``c`` ``[B, C_cond, L]``."""

    def __init__(self, in_channels: int, cond_channels: int, upsample_ratio: int,
                 conv_layers: int = 4, conv_kernel_size: int = 3, cond_hop_length: int = 256,
                 kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 kpnet_lrelu_slope: float = 0.1, kpnet_residual_style: str = "shared"):
        super().__init__()
        self.in_channels, self.conv_layers, self.cond_hop_length = \
            in_channels, conv_layers, cond_hop_length
        self.kernel_predictor = KernelPredictor(
            cond_channels, in_channels, 2 * in_channels, conv_layers, conv_kernel_size,
            kpnet_hidden_channels, kpnet_conv_size, kpnet_lrelu_slope, kpnet_residual_style)
        r = upsample_ratio
        self.upsample = nn.ConvTranspose1d(in_channels, in_channels, 2 * r, stride=r,
                                           padding=r // 2 + r % 2, output_padding=r % 2)
        for i in range(conv_layers):
            self.add_module(f"conv_{i}", _conv(in_channels, in_channels, conv_kernel_size, 3**i))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        kernels, bias = self.kernel_predictor(c)
        x = self.upsample(F.leaky_relu(x, 0.2))
        C = self.in_channels
        for i in range(self.conv_layers):
            y = F.leaky_relu(getattr(self, f"conv_{i}")(F.leaky_relu(x, 0.2)), 0.2)
            y = location_variable_convolution(y.transpose(1, 2), kernels[:, :, i],
                                              bias[:, :, i], self.cond_hop_length)
            x = x + (torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])).transpose(1, 2)
        return x


class UnivnetGenerator(nn.Module):
    """Noise ``[B, L, in_channels]`` and mel ``[B, L, cond_channels]`` →
    waveform ``[B, L * prod(upsample_factors), out_channels]``: an edge
    conv, one LVC block per upsampling factor, leaky ReLU, an edge conv,
    tanh."""

    def __init__(self, in_channels: int = 64, out_channels: int = 1, hidden_channels: int = 32,
                 cond_channels: int = 80, upsample_factors: Sequence[int] = (8, 8, 4),
                 lvc_layers_each_block: int = 4, lvc_kernel_size: int = 3,
                 kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 pad_mode: str = "zeros", kpnet_lrelu_slope: float = 0.1,
                 final_lrelu_slope: float = 0.1, kpnet_residual_style: str = "shared"):
        super().__init__()
        self.in_channels = in_channels
        self.pad_mode, self.final_lrelu_slope = pad_mode, final_lrelu_slope
        self.upsample_factors = tuple(upsample_factors)
        self.first_conv = nn.Conv1d(in_channels, hidden_channels, 7)
        cond_hop = 1
        for n, f in enumerate(self.upsample_factors):
            cond_hop *= f
            self.add_module(f"lvc_{n}", LVCBlock(
                hidden_channels, cond_channels, f, lvc_layers_each_block, lvc_kernel_size,
                cond_hop, kpnet_hidden_channels, kpnet_conv_size, kpnet_lrelu_slope,
                kpnet_residual_style))
        self.last_conv = nn.Conv1d(hidden_channels, out_channels, 7)

    def _edge_conv(self, conv: nn.Conv1d, h: torch.Tensor) -> torch.Tensor:
        return conv(F.pad(h, (3, 3), mode="reflect" if self.pad_mode == "reflect" else "constant"))

    def forward(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        c = c.transpose(1, 2)
        h = self._edge_conv(self.first_conv, x.transpose(1, 2))
        for n in range(len(self.upsample_factors)):
            h = getattr(self, f"lvc_{n}")(h, c)
        h = self._edge_conv(self.last_conv, F.leaky_relu(h, self.final_lrelu_slope))
        return torch.tanh(h).transpose(1, 2)

    def noise(self, c: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Standard normal noise ``[B, L, in_channels]`` for the mel ``c``,
        drawn from ``generator`` (on its device) and moved to ``c``'s."""
        g = generator or noise_generator(c.device)
        shape = (c.shape[0], c.shape[1], self.in_channels)
        return torch.randn(shape, generator=g, device=g.device, dtype=c.dtype).to(c.device)

    def inference(self, c: torch.Tensor, generator: Optional[torch.Generator] = None,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mel as it is (no padding), over noise ``x`` (drawn from
        ``generator`` when not given)."""
        return self(c, self.noise(c, generator) if x is None else x)
