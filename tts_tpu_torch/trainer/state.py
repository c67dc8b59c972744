"""Train state of named parameter groups (port of
``tts_tpu/trainer/state.py``): the step count, the groups' parameters (a
GAN's ``gen`` and ``disc``) and each group's optimizer state.

The JAX ``TrainState`` is an immutable pytree and ``apply_updates``
returns a new one; here the parameters are the model's own tensors,
updated in place by ``torch.optim`` (no second copy of the weights), and
``apply_updates`` returns the same state with its step advanced.
``state_dict``/``load_state_dict`` carry the step and every group's
optimizer state (moments, the schedule's update count, the accumulation
buffer) through a checkpoint; the parameters travel as the model's own
``state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from .optim import OptimizerState, Optimizer


@dataclass
class TrainState:
    step: int
    params: Dict[str, List[torch.nn.Parameter]]
    opt_states: Dict[str, OptimizerState]

    @classmethod
    def create(cls, params: Dict[str, List[torch.nn.Parameter]],
               optimizers: Dict[str, Optimizer]) -> "TrainState":
        opt_states = {k: optimizers[k].init(params[k]) for k in optimizers}
        return cls(step=0, params=params, opt_states=opt_states)

    def apply_updates(self, grads: Dict[str, List[torch.Tensor]]) -> "TrainState":
        """Each group's optimizer takes its gradients (``grads[k]``, in the
        order of ``params[k]``); every group reads its parameters as they
        were before the step, since no group shares a parameter."""
        for k, g in grads.items():
            self.opt_states[k].update(g)
        self.step += 1
        return self

    def state_dict(self) -> Dict:
        """``{"step": int, "<group>": OptimizerState.state_dict(), ...}``."""
        return {"step": self.step, **{k: v.state_dict() for k, v in self.opt_states.items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output; every group must be there."""
        missing = set(self.opt_states) - set(state)
        if missing:
            raise KeyError(f"optimizer state lacks the groups {sorted(missing)}")
        for k, opt in self.opt_states.items():
            opt.load_state_dict(state[k])
        self.step = int(state["step"])
