"""Normalizing-flow blocks of the GlowTTS decoder (port of
``tts_tpu/layers/glow.py:20-210``, reference ``TTS/tts/layers/glow_tts/glow.py``
and ``decoder.py``): ``squeeze``/``unsqueeze``, ``ActNorm``, ``InvConvNear``,
``CouplingBlock`` and ``GlowDecoder``, in both directions.

Every flow takes ``reverse``: the forward direction returns ``(z, logdet)``,
the reverse ``(x, None)``. Inference runs the reverse; the forward serves
the invertibility check and, later, training. Tensors are time-major
``[B, T, C]`` as in the JAX package; squeezing is a plain reshape there.
``InvConvNear`` keeps the JAX package's interleaved channel grouping and
inverts its ``[s, s]`` weight on each reverse call (``torch.linalg.inv_ex``,
which raises no error and so waits for no device result). Module and
parameter names follow the flax modules', so
``utils.convert.flax_to_state_dict`` maps the JAX parameters one to one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .wavenet import WN


def squeeze(x: torch.Tensor, x_mask: Optional[torch.Tensor], num_sqz: int = 2):
    """``[B, T, C] -> [B, T//n, n*C]``, grouping ``n`` consecutive frames
    (feature index ``s*C + c``); the mask keeps every ``n``-th frame's."""
    b, t, c = x.shape
    t = (t // num_sqz) * num_sqz
    x = x[:, :t].reshape(b, t // num_sqz, num_sqz * c)
    if x_mask is not None:
        x_mask = x_mask[:, num_sqz - 1 : t : num_sqz]
    else:
        x_mask = x.new_ones((b, t // num_sqz, 1))
    return x * x_mask, x_mask


def unsqueeze(x: torch.Tensor, x_mask: Optional[torch.Tensor], num_sqz: int = 2):
    """Inverse of :func:`squeeze`."""
    b, t, c = x.shape
    x = x.reshape(b, t * num_sqz, c // num_sqz)
    if x_mask is not None:
        x_mask = torch.repeat_interleave(x_mask, num_sqz, dim=1)
    else:
        x_mask = x.new_ones((b, t * num_sqz, 1))
    return x * x_mask, x_mask


def _mask(x: torch.Tensor, x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(x[..., :1]) if x_mask is None else x_mask


class ActNorm(nn.Module):
    """Per-channel affine flow ``z = exp(logs) * x + bias``."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        x_mask = _mask(x, x_mask)
        if reverse:
            return (x - self.bias) * torch.exp(-self.logs) * x_mask, None
        logdet = torch.sum(self.logs) * torch.sum(x_mask, dim=(1, 2))
        return (self.bias + torch.exp(self.logs) * x) * x_mask, logdet


class InvConvNear(nn.Module):
    """Invertible 1x1 convolution over ``num_splits`` interleaved channel
    groups: channel ``c = half*(C/2) + group*(s/2) + sub`` is mixed with the
    other halves and subs of its group by the ``[s, s]`` weight."""

    def __init__(self, channels: int, num_splits: int = 4):
        super().__init__()
        assert channels % num_splits == 0
        self.num_splits = num_splits
        self.weight = nn.Parameter(torch.eye(num_splits))  # drawn orthogonal by init_params

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        b, t, c = x.shape
        s = self.num_splits
        x_mask = _mask(x, x_mask)
        xg = x.reshape(b, t, 2, c // s, s // 2).permute(0, 1, 2, 4, 3).reshape(b, t, s, c // s)
        if reverse:
            w, logdet = torch.linalg.inv_ex(self.weight)[0], None
        else:
            w = self.weight
            logdet = torch.linalg.slogdet(self.weight)[1] * (c / s) * torch.sum(x_mask, dim=(1, 2))
        z = torch.einsum("ij,btjc->btic", w, xg)
        z = z.reshape(b, t, 2, s // 2, c // s).permute(0, 1, 2, 4, 3).reshape(b, t, c)
        return z * x_mask, logdet


class CouplingBlock(nn.Module):
    """Affine coupling: the first half of the channels, through ``start``, a
    WaveNet stack (conditioned on ``g`` when ``c_in_channels`` > 0) and
    ``end``, gives the mean and log-scale that transform the second half."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int, c_in_channels: int = 0,
                 sigmoid_scale: bool = False):
        super().__init__()
        self.sigmoid_scale = sigmoid_scale
        self.start = nn.Linear(in_channels // 2, hidden_channels)
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, num_layers, c_in_channels)
        self.end = nn.Linear(hidden_channels, in_channels)

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        x_mask = _mask(x, x_mask)
        half = x.shape[-1] // 2
        x_0, x_1 = x[..., :half], x[..., half:]
        h = self.wn(self.start(x_0) * x_mask, x_mask, g=g)
        out = self.end(h)
        m, logs = out[..., :half], out[..., half:]
        if self.sigmoid_scale:
            logs = torch.log(1e-6 + torch.sigmoid(logs + 2))
        if reverse:
            z_1, logdet = (x_1 - m) * torch.exp(-logs) * x_mask, None
        else:
            z_1 = (m + torch.exp(logs) * x_1) * x_mask
            logdet = torch.sum(logs * x_mask, dim=(1, 2))
        return torch.cat([x_0, z_1], dim=-1), logdet


class GlowDecoder(nn.Module):
    """Squeeze → [ActNorm → InvConvNear → CouplingBlock] × N → unsqueeze."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_flow_blocks: int, num_coupling_layers: int,
                 num_splits: int = 4, num_squeeze: int = 2, sigmoid_scale: bool = False,
                 c_in_channels: int = 0):
        super().__init__()
        self.num_squeeze = num_squeeze
        self.num_flow_blocks = num_flow_blocks
        ch = in_channels * num_squeeze
        for k in range(num_flow_blocks):
            self.add_module(f"actnorm_{k}", ActNorm(ch))
            self.add_module(f"invconv_{k}", InvConvNear(ch, num_splits))
            self.add_module(f"coupling_{k}", CouplingBlock(
                ch, hidden_channels, kernel_size, dilation_rate, num_coupling_layers,
                c_in_channels, sigmoid_scale))

    def flows(self):
        return [getattr(self, f"{kind}_{k}") for k in range(self.num_flow_blocks)
                for kind in ("actnorm", "invconv", "coupling")]

    def forward(self, x, x_mask, g=None, reverse: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """``(z, total logdet or None, mask)``; the mask comes back at the
        input's frame rate, cut to a multiple of ``num_squeeze``."""
        if self.num_squeeze > 1:
            x, x_mask = squeeze(x, x_mask, self.num_squeeze)
        logdet_tot = None if reverse else x.new_zeros(x.shape[0])
        for f in (reversed(self.flows()) if reverse else self.flows()):
            x, logdet = f(x, x_mask, g=g, reverse=reverse)
            if not reverse:
                logdet_tot = logdet_tot + logdet
        if self.num_squeeze > 1:
            x, x_mask = unsqueeze(x, x_mask, self.num_squeeze)
        return x, logdet_tot, x_mask
