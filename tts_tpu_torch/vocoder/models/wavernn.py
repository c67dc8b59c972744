"""WaveRNN, the autoregressive vocoder (port of ``tts_tpu/vocoder/models/wavernn.py:20-244``,
reference ``TTS/vocoder/models/wavernn.py``): ``MelResNet`` (layer norms, or
the ``folded`` eval-mode BatchNorms of a converted checkpoint),
``UpsampleNetwork``, ``Wavernn`` with its teacher-forced ``forward`` and its
sample-by-sample ``generate``, ``sample_from_discretized_mix_logistic``,
and training (``:247-354``): ``mulaw_encode``, ``mixture_of_logistics_loss``
and ``WavernnVocoder``, the wrapper the trainer's generic step runs.

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
``GRUCell`` Denses packed into ``nn.GRUCell``).

The teacher-forced ``forward`` (training) knows every step's input ahead:
the first GRU reads the given samples and the conditioning, the second the
first's outputs. So each GRU runs over the whole sequence in one call that
shares the cell's weights (``torch._VF.gru``, cuDNN's on the card), where
the JAX module scans the two cells a sample; both compute the same
recurrence (``tests/test_torch_vocoders.py`` holds the logits against the
JAX ``Wavernn.__call__``). ``generate`` keeps its loop: each step there
reads the sample it drew before.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch.vocoder.layers import init_weights, noise_generator, shared_tap_upsample


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


def _gru_sequence(cell: nn.GRUCell, x: torch.Tensor) -> torch.Tensor:
    """``cell`` over a whole sequence ``[T, B, C_in]`` from a zero state →
    every step's state ``[T, B, hidden]``: one multi-step GRU call on the
    cell's own weights (the same recurrence as ``cell`` step by step)."""
    h0 = x.new_zeros(1, x.shape[1], cell.hidden_size)
    weights = [cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh]
    with warnings.catch_warnings():  # cuDNN copies the four weights into one buffer
        warnings.simplefilter("ignore", UserWarning)
        out, _ = torch._VF.gru(x, h0, weights, True, 1, 0.0, cell.training, False, False)
    return out


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
        one before it) → logits ``[B, T, n_classes]``, each GRU over the
        whole sequence at once."""
        B, T = x.shape
        pre, a2, a3, a4 = self._conditioning(mels, T)
        h = pre + x.t()[..., None] * self.I.weight[:, 0]  # [T, B, rnn_dims]
        h = _gru_sequence(self.rnn1, h) + h
        h = _gru_sequence(self.rnn2, torch.cat([h, a2], -1)) + h
        h = F.relu(self.fc1(torch.cat([h, a3], -1)))
        h = F.relu(self.fc2(torch.cat([h, a4], -1)))
        return self.fc3(h).transpose(0, 1)

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


def mulaw_encode(w: torch.Tensor, mu: int) -> torch.Tensor:
    """mu-law companding to integer labels in ``[0, mu]`` (port of
    ``mulaw_encode_jnp``, ``wavernn.py:257-261``)."""
    comp = torch.sign(w) * torch.log1p(mu * torch.abs(w)) / math.log1p(mu)
    return torch.clamp(torch.floor((comp + 1) / 2 * mu + 0.5), 0, mu).long()


def mixture_of_logistics_loss(logits: torch.Tensor, y: torch.Tensor, num_classes: int = 65536,
                              log_scale_min: float = -32.23) -> torch.Tensor:
    """The discretized mixture-of-logistics NLL of targets ``y`` ``[B, T]``
    in ``[-1, 1]`` under ``logits`` ``[B, T, 3 n_mix]`` (port of
    ``wavernn.py:324-354``, reference ``distribution.py:89``)."""
    nr_mix = logits.shape[-1] // 3
    logit_probs = logits[..., :nr_mix]
    means = logits[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(logits[..., 2 * nr_mix:], min=log_scale_min)
    y = y[..., None]
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - np.log((num_classes - 1) / 2))
    log_probs = torch.where(y < -0.999, log_cdf_plus,
                            torch.where(y > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + F.log_softmax(logit_probs, -1)
    return -torch.mean(torch.logsumexp(log_probs, dim=-1))


class WavernnVocoder:
    """WaveRNN's training wrapper (port of ``wavernn.py:264-321``): the
    network (``module``, layer norms unless ``model_args`` says otherwise),
    the teacher-forcing targets and the loss by output mode, the hooks of
    the trainer's generic single-optimizer step.

    A batch's waveform ``[B, seq_len, 1]`` loses ``pad`` frames at each end
    (the resnet's valid convolution): the ``usable`` samples from
    ``offset`` are the targets, each predicted from the one before (its
    mu-law or linear class for an integer ``mode``). The loss: the mixture
    of logistics (``"mold"``), a Gaussian NLL with the log deviation
    clipped at -7 (``"gauss"``), else the cross-entropy over the classes."""

    def __init__(self, config):
        import inspect

        self.config = config
        valid = set(inspect.signature(Wavernn.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in (config.model_args or {}).items() if k in valid}
        kwargs.setdefault("feat_dims", config.audio.num_mels)
        kwargs.setdefault("mode", config.mode)
        kwargs.setdefault("mulaw", getattr(config, "mulaw", True))
        with torch.device("meta"):
            self.module = Wavernn(**kwargs).eval()
        self.pad = int(kwargs.get("pad", 2))
        hop = self.module.hop
        frames = max(2 * self.pad + 1, config.seq_len // hop)
        self.usable = (frames - 2 * self.pad) * hop
        self.offset = self.pad * hop
        self.initialized = False

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", discriminator: bool = False):
        """Random fp32 weights from ``seed`` (``vocoder.layers.init_weights``);
        ``discriminator`` is ignored (there is none)."""
        from tts_tpu_torch import resolve_device

        gen = torch.Generator().manual_seed(seed)
        module = init_weights(self.module.to_empty(device="cpu"), gen)
        self.module = module.to(resolve_device(device)).requires_grad_(False)
        self.initialized = True
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)
        self.initialized = True

    def targets(self, wav: torch.Tensor):
        """``wav [B, T, 1]`` → the teacher-forcing input ``x [B, usable - 1]``
        (float) and the targets ``y [B, usable - 1]`` (samples, or class
        ids for an integer ``mode``)."""
        start = max(0, min(self.offset, wav.shape[1] - self.usable))  # dynamic_slice clamps so
        w = wav[:, start:start + self.usable, 0]
        mode = self.module.mode
        if isinstance(mode, int):
            n = self.module.n_classes
            labels = (mulaw_encode(w, n - 1) if self.module.mulaw
                      else torch.clamp(torch.floor((w + 1) / 2 * (n - 1) + 0.5), 0, n - 1).long())
            return 2.0 * labels[:, :-1].float() / (n - 1.0) - 1.0, labels[:, 1:]
        return w[:, :-1], w[:, 1:]

    def train_step(self, batch, generator: Optional[torch.Generator] = None,
                   train: bool = True):
        """``(loss, {"wavernn_loss": loss})`` of the teacher-forced pass; it
        draws nothing, so ``generator`` and ``train`` change nothing."""
        x, y = self.targets(batch["waveform"])
        logits = self.module(x, batch["mel"]).float()
        mode = self.module.mode
        if mode == "mold":
            loss = mixture_of_logistics_loss(logits, y)
        elif mode == "gauss":
            mean, logstd = logits[..., 0], torch.clamp(logits[..., 1], min=-7.0)
            loss = torch.mean(0.5 * np.log(2 * np.pi) + logstd
                              + 0.5 * ((y - mean) * torch.exp(-logstd)) ** 2)
        else:
            logp = F.log_softmax(logits, dim=-1)
            loss = -torch.mean(torch.gather(logp, -1, y[..., None]))
        return loss, {"wavernn_loss": loss}

    def get_dataset(self, config, samples, is_eval: bool = False):
        from tts_tpu_torch.vocoder.dataset import GANDataset

        return GANDataset(config, samples, is_eval=is_eval)

    def format_batch(self, batch: dict) -> dict:
        return batch
