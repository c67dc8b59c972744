"""Learning-rate schedules and optimizers (port of
``tts_tpu/trainer/optim.py``) on ``torch.optim``.

``build_lr_schedule`` gives a function of the update count (or a constant):
NoamLR, ExponentialLR (``gamma`` per ``steps_per_epoch`` updates), StepLR and
StepwiseGradualLR, as the JAX package defines them. ``build_optimizer``
gives an :class:`Optimizer` that does what the JAX package's optax chain
does, in its order:

- ``skip_non_finite``: a call whose gradients hold a NaN or an Inf changes
  nothing, neither the parameters nor any state (``optax.apply_if_finite``,
  which the JAX package sets never to give up);
- ``grad_accum = k``: the gradients of ``k`` calls are averaged (the running
  mean of ``optax.MultiSteps``) and applied on every k-th call;
- ``grad_clip``: optax's ``clip_by_global_norm``, which scales every
  gradient by ``max / norm`` when the global norm is not below ``max``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and would
  not agree);
- the update, by AdamW, Adam or SGD of ``torch.optim`` (their arithmetic is
  optax's), or RAdam and RMSprop written here as optax computes them
  (``torch.optim.RAdam`` puts ``eps`` under the bias correction's root and
  ``torch.optim.RMSprop`` outside the root);
- the learning rate is the schedule read at the number of updates applied
  before this one, as optax reads it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["build_lr_schedule", "build_optimizer", "build_gan_optimizers", "Optimizer",
           "OptimizerState"]

Schedule = Union[float, Callable[[int], float]]


def build_lr_schedule(name: Optional[str], lr: float, params: Optional[dict] = None) -> Schedule:
    """The learning rate by reference scheduler name: a constant (no name)
    or a function of the update count."""
    params = params or {}
    if not name:
        return lr
    name = name.lower()
    if name == "noamlr":
        warmup = params.get("warmup_steps", 4000)

        def noam(step: int) -> float:
            s = max(float(step), 1.0)
            return lr * warmup**0.5 * min(s**-0.5, s * warmup**-1.5)

        return noam
    if name == "exponentiallr":
        gamma = params.get("gamma", 0.999875)
        # per epoch in the reference (scheduler_after_epoch); per update here
        # unless steps_per_epoch is given, as in the JAX package
        steps_per_epoch = params.get("steps_per_epoch", 1)
        return lambda step: lr * gamma ** (step // steps_per_epoch)
    if name == "steplr":
        step_size = params.get("step_size", 30)
        gamma = params.get("gamma", 0.1)
        return lambda step: lr * gamma ** (step // step_size)
    if name == "stepwisegraduallr":
        # the last [threshold, lr] pair (in list order) whose threshold <= step
        pairs = params.get("gradual_learning_rates") or [[0, lr]]

        def gradual(step: int) -> float:
            idx = max([i for i, p in enumerate(pairs) if float(p[0]) <= step], default=0)
            return float(pairs[idx][1])

        return gradual
    raise ValueError(f"Unknown lr scheduler {name!r}")


def _pow_f32(base: float, n: int) -> np.float32:
    """``base ** n`` in fp32 by repeated squaring: optax's ``decay ** count``
    (an fp32 base to an int32 power), to the bit."""
    result, b = np.float32(1), np.float32(base)
    while n:
        if n & 1:
            result = np.float32(result * b)
        b, n = np.float32(b * b), n >> 1
    return result


class _RAdam(torch.optim.Optimizer):
    """optax's ``scale_by_radam`` (threshold 5) followed by decoupled weight
    decay and the learning rate. The step's scalars (bias corrections, the
    variance's ``ro`` and the rectification) are computed in fp32, as optax
    computes them: near the threshold the rectification magnifies their
    rounding."""

    def __init__(self, params, lr, betas, eps, weight_decay):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                g = p.grad
                st["count"] += 1
                t = st["count"]
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).add_(g * g, alpha=1 - b2)
                f32 = np.float32
                b2t = _pow_f32(b2, t)
                ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
                mu_hat = st["mu"] / float(f32(1) - _pow_f32(b1, t))
                if ro >= 5.0:
                    r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                                / (f32(ro_inf - 4.0) * f32(ro_inf - 2.0) * ro))
                    upd = float(r) * mu_hat / (torch.sqrt(st["nu"] / float(f32(1) - b2t))
                                               + group["eps"])
                else:
                    upd = mu_hat
                if group["weight_decay"]:
                    upd = upd + group["weight_decay"] * p
                p.add_(upd, alpha=-group["lr"])


class _RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``: ``g / sqrt(nu + eps)``, ``nu`` from 0."""

    def __init__(self, params, lr, alpha, eps):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                st["nu"].mul_(group["alpha"]).add_(p.grad * p.grad, alpha=1 - group["alpha"])
                p.add_(p.grad * torch.rsqrt(st["nu"] + group["eps"]), alpha=-group["lr"])


@dataclass
class Optimizer:
    """What :func:`build_optimizer` returns: the recipe of one parameter
    group's optimizer; :meth:`init` binds it to the parameters."""

    name: str
    lr: Schedule
    betas: Sequence[float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0
    alpha: float = 0.99
    grad_clip: float = 0.0
    grad_accum: int = 1
    skip_non_finite: bool = False

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: Sequence[torch.nn.Parameter]) -> "OptimizerState":
        params = list(params)
        b1, b2 = self.betas
        if self.name == "adamw":
            opt = torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=self.eps,
                                    weight_decay=self.weight_decay)
        elif self.name == "adam":
            opt = torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=self.eps)
        elif self.name == "radam":
            opt = _RAdam(params, 0.0, (b1, b2), self.eps, self.weight_decay)
        elif self.name == "sgd":
            opt = torch.optim.SGD(params, lr=0.0, momentum=self.momentum)
        elif self.name == "rmsprop":
            opt = _RMSprop(params, 0.0, self.alpha, self.eps)
        else:
            raise ValueError(f"Unknown optimizer {self.name!r}")
        return OptimizerState(self, params, opt)


@dataclass
class OptimizerState:
    """One group's optimizer bound to its parameters, with the counts of
    the wrappers: ``count`` updates applied (the schedule's step),
    ``mini_step`` gradients accumulated toward the next one, and
    ``notfinite_count`` calls skipped in a row."""

    spec: Optimizer
    params: List[torch.nn.Parameter]
    torch_optimizer: torch.optim.Optimizer
    count: int = 0
    mini_step: int = 0
    notfinite_count: int = 0
    acc: Optional[List[torch.Tensor]] = field(default=None, repr=False)

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one call's gradients (one a parameter, in order); returns
        whether the parameters were updated."""
        spec = self.spec
        grads = [g.float() for g in grads]
        if spec.skip_non_finite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            if not bool(finite):
                self.notfinite_count += 1
                return False
            self.notfinite_count = 0
        if spec.grad_accum > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            if n < spec.grad_accum - 1:
                self.mini_step += 1
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        if spec.grad_clip and spec.grad_clip > 0:  # branch-free: no host sync
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < spec.grad_clip
            grads = [torch.where(keep, g, (g / norm) * spec.grad_clip) for g in grads]
        lr = spec.learning_rate(self.count)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self.torch_optimizer.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The counts, the accumulation buffer (``None`` between updates) and
        the ``torch.optim`` state (moments, its own step counts), in plain
        types and tensors: a checkpoint that loads with ``weights_only``."""
        return {"count": self.count, "mini_step": self.mini_step,
                "notfinite_count": self.notfinite_count,
                "acc": None if self.acc is None else [a.detach().clone() for a in self.acc],
                "torch_optimizer": self.torch_optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output onto these parameters (their
        device): the schedule reads the restored ``count`` and
        ``grad_accum`` resumes its running mean."""
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.notfinite_count = int(state["notfinite_count"])
        device = self.params[0].device if self.params else None
        self.acc = None if state["acc"] is None else [a.to(device) for a in state["acc"]]
        self.torch_optimizer.load_state_dict(state["torch_optimizer"])


def build_optimizer(name: str, lr: Schedule, params: Optional[dict] = None,
                    grad_clip: float = 0.0, grad_accum: int = 1,
                    skip_non_finite: bool = False) -> Optimizer:
    """An optimizer by reference name (AdamW, Adam, RAdam, SGD, RMSprop) with
    ``optimizer_params`` (``betas``, ``eps``, ``weight_decay``, SGD's
    ``momentum``, RMSprop's ``alpha``), a global-norm clip, gradient
    accumulation over ``grad_accum`` calls and the skip of non-finite
    gradients (see the module's docstring)."""
    params = dict(params or {})
    name = (name or "adamw").lower()
    if name not in ("adamw", "adam", "radam", "sgd", "rmsprop"):
        raise ValueError(f"Unknown optimizer {name!r}")
    betas = params.pop("betas", (0.9, 0.999))
    return Optimizer(
        name=name, lr=lr, betas=(float(betas[0]), float(betas[1])),
        eps=params.pop("eps", 1e-8), weight_decay=params.pop("weight_decay", 0.0),
        momentum=params.pop("momentum", 0.0), alpha=params.pop("alpha", 0.99),
        grad_clip=grad_clip or 0.0, grad_accum=int(grad_accum or 1),
        skip_non_finite=bool(skip_non_finite),
    )


def build_gan_optimizers(config) -> dict:
    """The ``gen`` and ``disc`` optimizers of a GAN config (VITS, the GAN
    vocoders): ``optimizer`` and ``optimizer_params`` for both, each group's
    ``lr_gen``/``lr_disc`` and schedule, the first of ``grad_clip`` (a number
    or a list), ``grad_accum_steps``, ``skip_non_finite_grads`` (port of
    ``tts_tpu/models/vits/train.py:35-47`` and
    ``tts_tpu/vocoder/models/gan.py:60-70``)."""
    clip = config.grad_clip[0] if isinstance(config.grad_clip, (list, tuple)) \
        else config.grad_clip
    accum = int(getattr(config, "grad_accum_steps", 1) or 1)
    skip_nf = bool(getattr(config, "skip_non_finite_grads", False))
    return {
        group: build_optimizer(config.optimizer,
                               build_lr_schedule(getattr(config, f"lr_scheduler_{group}"),
                                                 getattr(config, f"lr_{group}"),
                                                 getattr(config, f"lr_scheduler_{group}_params")),
                               config.optimizer_params, clip, accum, skip_nf)
        for group in ("gen", "disc")
    }
