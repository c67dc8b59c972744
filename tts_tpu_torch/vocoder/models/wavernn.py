"""WaveRNN, the autoregressive vocoder (port of ``tts_tpu/vocoder/models/wavernn.py:20-244``,
reference ``TTS/vocoder/models/wavernn.py``): ``MelResNet`` (layer norms, or
the ``folded`` eval-mode BatchNorms of a converted checkpoint),
``UpsampleNetwork``, ``Wavernn`` with its teacher-forced ``forward`` and its
sample-by-sample ``generate``, and ``sample_from_discretized_mix_logistic``,
inference only.

Each output sample runs one step: a dense layer over the previous sample,
the upsampled mel and the first aux quarter, two ``GRUCell``s with residuals,
two dense layers with the other aux quarters, the output layer, and a draw
by ``mode``: a mixture of logistics (``"mold"``), a Gaussian (``"gauss"``),
or a class of ``2**mode`` (integer ``mode``). The loop runs in Python, one
step a sample; the parts of each step that do not read the previous sample
(the mel and aux terms of the first dense layer) are computed for every
step at once first. The random draws come all at once before the loop, from
an explicit ``torch.Generator`` or from ``noise`` (:func:`draw_noise`):
Gumbel noise for a categorical choice (``jax.random.categorical`` adds
Gumbel noise too), uniforms for the logistic, normals for the Gaussian.

As in the JAX package, ``generate`` does not fold a long mel into batched
segments (the reference's ``target_samples`` and ``overlap_samples``), its
output is ``2 * pad`` frames shorter than the mel (the resnet's valid conv
and the crop; ROADMAP.md F32), and an integer ``mode`` returns
``2 * idx / (n - 1) - 1`` with no mu-law decode, whatever ``mulaw`` says
(ROADMAP.md F33).

Public layout is the JAX package's: mel ``[B, T_mel, M]``; ``forward`` takes
``x`` ``[B, T_wav]`` and returns logits ``[B, T_wav, n_classes]``,
``generate`` returns ``[B, T_wav]``. Names follow the flax modules', so
``utils.convert.wavernn_from_jax_params`` maps the JAX parameters (flax's
``GRUCell`` Denses packed into ``nn.GRUCell``). Training waits for ROADMAP.md
item 17.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import noise_generator, shared_tap_upsample


class MelResNet(nn.Module):
    """A valid ``2 pad + 1`` conv, ``num_res_blocks`` residual pairs of 1x1
    convs, a 1x1 output conv; ``[B, M, T]`` → ``[B, res_out_dims, T - 2 pad]``.
    ``norm_type`` ``"layer"`` normalises over channels (flax's epsilon,
    1e-6), ``"folded"`` is a per-channel scale and shift."""

    def __init__(self, num_res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int, norm_type: str = "layer"):
        super().__init__()
        self.num_res_blocks, self.norm_type = num_res_blocks, norm_type
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1, bias=False)
        norms = ["norm_in"]
        for i in range(num_res_blocks):
            self.add_module(f"res{i}_conv1", nn.Conv1d(compute_dims, compute_dims, 1, bias=False))
            self.add_module(f"res{i}_conv2", nn.Conv1d(compute_dims, compute_dims, 1, bias=False))
            norms += [f"res{i}_norm1", f"res{i}_norm2"]
        for name in norms:
            if norm_type == "folded":
                self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(compute_dims)))
                self.register_parameter(f"{name}_shift", nn.Parameter(torch.zeros(compute_dims)))
            else:
                self.add_module(name, nn.LayerNorm(compute_dims, eps=1e-6))
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.norm_type == "folded":
            return x * getattr(self, f"{name}_scale")[:, None] + getattr(self, f"{name}_shift")[:, None]
        return getattr(self, name)(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self._norm(self.conv_in(x), "norm_in"))
        for i in range(self.num_res_blocks):
            h = F.relu(self._norm(getattr(self, f"res{i}_conv1")(x), f"res{i}_norm1"))
            x = self._norm(getattr(self, f"res{i}_conv2")(h), f"res{i}_norm2") + x
        return self.conv_out(x)


class UpsampleNetwork(nn.Module):
    """Mel ``[B, M, T]`` → the mel at the sample rate ``[B, M, (T - 2 pad)
    * hop]`` (nearest repeats, each smoothed by one tap shared across
    channels, ``pad * hop`` samples cropped at each end) and the resnet's
    aux features repeated to the same length (or ``None``)."""

    def __init__(self, feat_dims: int, upsample_factors: Sequence[int], compute_dims: int,
                 num_res_blocks: int, res_out_dims: int, pad: int, use_aux_net: bool = True,
                 norm_type: str = "layer"):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.indent = pad * int(np.prod(self.upsample_factors))
        if use_aux_net:
            self.resnet = MelResNet(num_res_blocks, feat_dims, compute_dims, res_out_dims, pad,
                                    norm_type)
        for i, f in enumerate(self.upsample_factors):
            k = 2 * f + 1
            self.register_parameter(f"up_{i}", nn.Parameter(torch.full((k, 1, 1), 1.0 / k)))

    def forward(self, m: torch.Tensor):
        aux = None
        if hasattr(self, "resnet"):
            aux = torch.repeat_interleave(self.resnet(m), int(np.prod(self.upsample_factors)),
                                          dim=2)
        x = m
        for i, f in enumerate(self.upsample_factors):
            x = shared_tap_upsample(x, getattr(self, f"up_{i}"), f)
        if self.indent > 0:
            x = x[:, :, self.indent:-self.indent]
        return x, aux


def sample_from_discretized_mix_logistic(logits: torch.Tensor, gumbel: torch.Tensor,
                                         u: torch.Tensor,
                                         log_scale_min: float = -32.23) -> torch.Tensor:
    """A draw from the mixture of logistics ``logits`` ``[B, 3 n_mix]``
    (weights, means, log scales): the component by Gumbel-max over the
    weights with ``gumbel`` ``[B, n_mix]``, then the logistic's inverse CDF
    at ``u`` ``[B]`` (in ``(1e-5, 1 - 1e-5)``), clipped to ±1."""
    nr_mix = logits.shape[-1] // 3
    comp = torch.argmax(logits[..., :nr_mix] + gumbel, dim=-1, keepdim=True)
    mean = torch.gather(logits[..., nr_mix:2 * nr_mix], -1, comp)[..., 0]
    log_scale = torch.gather(torch.clamp(logits[..., 2 * nr_mix:], min=log_scale_min), -1,
                             comp)[..., 0]
    x = mean + torch.exp(log_scale) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


class Wavernn(nn.Module):
    """Mel ``[B, T_mel, feat_dims]`` → ``(T_mel - 2 pad) * hop`` samples, one
    step a sample."""

    def __init__(self, rnn_dims: int = 512, fc_dims: int = 512, compute_dims: int = 128,
                 res_out_dims: int = 128, num_res_blocks: int = 10, feat_dims: int = 80,
                 pad: int = 2, mode="mold", mulaw: bool = True, use_aux_net: bool = True,
                 upsample_factors: Sequence[int] = (4, 8, 8), norm_type: str = "layer"):
        super().__init__()
        self.rnn_dims, self.mode, self.mulaw = rnn_dims, mode, mulaw
        self.use_aux_net = use_aux_net
        self.aux_dims = res_out_dims // 4
        self.hop = int(np.prod(upsample_factors))
        self.upsample = UpsampleNetwork(feat_dims, upsample_factors, compute_dims,
                                        num_res_blocks, res_out_dims, pad, use_aux_net,
                                        norm_type)
        aux = self.aux_dims if use_aux_net else 0
        self.I = nn.Linear(feat_dims + 1 + aux, rnn_dims)
        self.rnn1 = nn.GRUCell(rnn_dims, rnn_dims)
        self.rnn2 = nn.GRUCell(rnn_dims + aux, rnn_dims)
        self.fc1 = nn.Linear(rnn_dims + aux, fc_dims)
        self.fc2 = nn.Linear(fc_dims + aux, fc_dims)
        self.fc3 = nn.Linear(fc_dims, self.n_classes)

    @property
    def n_classes(self) -> int:
        if isinstance(self.mode, int):
            return 2**self.mode
        if self.mode == "mold":
            return 30
        if self.mode == "gauss":
            return 2
        raise ValueError(f"Unknown mode {self.mode}")

    def _conditioning(self, mels: torch.Tensor, T: Optional[int] = None):
        """The per-sample inputs that do not depend on the samples: the
        first dense layer's mel and aux terms with its bias ``[T, B,
        rnn_dims]``, and the other three aux quarters, each ``[T, B, d]``
        (empty without the aux net)."""
        mels_up, aux = self.upsample(mels.transpose(1, 2))
        T = T or mels_up.shape[2]
        mels_up = mels_up[:, :, :T].permute(2, 0, 1)
        d = self.aux_dims
        if aux is None:
            quarters = [mels_up.new_zeros(T, mels_up.shape[1], 0)] * 4
        else:
            aux = aux[:, :, :T].permute(2, 0, 1)
            quarters = [aux[..., i * d:(i + 1) * d] for i in range(4)]
        pre = F.linear(torch.cat([mels_up, quarters[0]], -1), self.I.weight[:, 1:], self.I.bias)
        return pre, quarters[1], quarters[2], quarters[3]

    def _step(self, x_prev, pre_t, a2, a3, a4, h1, h2):
        """One sample: the previous sample ``x_prev`` ``[B]`` → logits."""
        x = pre_t + x_prev[:, None] * self.I.weight[:, 0]
        h1 = self.rnn1(x, h1)
        x = h1 + x
        h2 = self.rnn2(torch.cat([x, a2], -1), h2)
        x = h2 + x
        x = F.relu(self.fc1(torch.cat([x, a3], -1)))
        x = F.relu(self.fc2(torch.cat([x, a4], -1)))
        return self.fc3(x), h1, h2

    def forward(self, x: torch.Tensor, mels: torch.Tensor) -> torch.Tensor:
        """Teacher forced: the samples ``x`` ``[B, T]`` (each step reads the
        one before it) → logits ``[B, T, n_classes]``."""
        B, T = x.shape
        pre, a2, a3, a4 = self._conditioning(mels, T)
        h1 = h2 = x.new_zeros(B, self.rnn_dims)
        logits = []
        for t in range(T):
            out, h1, h2 = self._step(x[:, t], pre[t], a2[t], a3[t], a4[t], h1, h2)
            logits.append(out)
        return torch.stack(logits, 1)

    def noise_shapes(self, T: int, B: int) -> Dict[str, tuple]:
        """The draws ``generate`` takes for ``T`` samples of ``B`` rows: Gumbel
        noise over the mixture components (``"mold"``) or the classes
        (integer ``mode``), a uniform for the logistic, a normal for the
        Gaussian."""
        if self.mode == "mold":
            return {"gumbel": (T, B, self.n_classes // 3), "uniform": (T, B)}
        if self.mode == "gauss":
            return {"normal": (T, B)}
        return {"gumbel": (T, B, self.n_classes)}

    def draw_noise(self, T: int, B: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Every draw of a ``T``-sample ``generate`` at once, on the
        generator's device: Gumbel as ``-log(-log(u))``, uniforms in
        ``[1e-5, 1 - 1e-5)``, standard normals."""
        out = {}
        for name, shape in self.noise_shapes(T, B).items():
            if name == "normal":
                out[name] = torch.randn(shape, generator=generator, device=generator.device)
                continue
            u = torch.rand(shape, generator=generator, device=generator.device)
            if name == "gumbel":
                tiny = torch.finfo(torch.float32).tiny
                out[name] = -torch.log(-torch.log(u.clamp(min=tiny)))
            else:
                out[name] = 1e-5 + u * (1 - 2e-5)
        return out

    @torch.no_grad()
    def generate(self, mels: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Sample by sample from the mel ``[B, T_mel, M]`` → ``[B, (T_mel -
        2 pad) * hop]``, each step's draw from ``noise`` (:meth:`noise_shapes`,
        indexed by step) or, without it, from ``generator``."""
        pre, a2, a3, a4 = self._conditioning(mels)
        T, B = pre.shape[:2]
        if noise is None:
            noise = self.draw_noise(T, B, generator or noise_generator(mels.device))
        noise = {k: v.to(mels) for k, v in noise.items()}
        h1 = h2 = mels.new_zeros(B, self.rnn_dims)
        sample = mels.new_zeros(B)
        samples = []
        for t in range(T):
            logits, h1, h2 = self._step(sample, pre[t], a2[t], a3[t], a4[t], h1, h2)
            if self.mode == "mold":
                sample = sample_from_discretized_mix_logistic(logits, noise["gumbel"][t],
                                                              noise["uniform"][t])
            elif self.mode == "gauss":
                sample = logits[:, 0] + torch.exp(logits[:, 1]) * noise["normal"][t]
            else:
                idx = torch.argmax(logits + noise["gumbel"][t], dim=-1)
                sample = 2.0 * idx.to(mels.dtype) / (self.n_classes - 1.0) - 1.0
            samples.append(sample)
        return torch.stack(samples, 1)
