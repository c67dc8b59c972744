"""Shared pieces of the acoustic models' training parity tests
(``test_torch_{forward,glow,align}_tts_train.py``): a batch drawn from a
numpy seed, the JAX ``Trainer``'s own generic step on carried parameters,
the port's ``Trainer`` generic step, and their comparison.

The JAX ``Trainer`` is a bare instance (``object.__new__``, its mesh and
data plumbing left out) whose ``_build_generic_step`` runs on the drawn
parameters, jitted once a case with LLVM's cheap options; the gradients
it computes come out of the jitted step through ``jax.debug.callback``
around ``tts_tpu.trainer.trainer.mp_value_and_grad`` (no second program to
compile). Every dropout is 0 (a ``torch.Generator`` cannot
replay ``jax.random``; dropout has its own tests), so the step's keys draw
nothing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tts_tpu.trainer.trainer as jax_trainer_mod
from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs

COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
STEPS = 3


def acoustic_batch(seed=0, B=2, T_en=12, T_de=48, C=16, vocab=40, text_lengths=(12, 9),
                   mel_lengths=(48, 35), pitch=False, energy=False):
    """Token ids, a mel and (normalised, F60) pitch and energy with a third
    of their frames unvoiced; numpy, the trainer's keys and types."""
    rs = np.random.RandomState(seed)
    batch = {"text_input": rs.randint(1, vocab, (B, T_en)).astype(np.int32),
             "text_lengths": np.asarray(text_lengths, np.int32),
             "mel_lengths": np.asarray(mel_lengths, np.int32),
             "mel_input": (rs.randn(B, T_de, C) * 0.5 - 1.0).astype(np.float32)}
    for key, on in (("pitch", pitch), ("energy", energy)):
        if on:
            v = rs.randn(B, T_de, 1).astype(np.float32)
            batch[key] = np.where(rs.rand(B, T_de, 1) < 0.33, 0.0, v).astype(np.float32)
    return batch


def to_torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text_input"] = out["text_input"].long()
    return out


def jax_generic_run(jm, jcfg, params, batch, carry, steps=STEPS):
    """``steps`` steps of the JAX ``Trainer``'s generic step from
    ``params``: per step its metrics, the gradients at the step's
    parameters and the parameters after it, both carried to the port's
    names by ``carry``; the last step also keeps the JAX tree
    (``"jax_params"``)."""
    t = object.__new__(jax_trainer_mod.Trainer)
    t.config, t.model, t.grad_accum, t.mixed_precision = jcfg, jm, 1, False
    t.rng = jax.random.PRNGKey(jcfg.seed)
    jm.init_params = lambda rng: params
    t._build_generic_step()
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    recorded = []
    value_and_grad = jax_trainer_mod.mp_value_and_grad

    def recording(fn, *args, **kwargs):
        inner = value_and_grad(fn, *args, **kwargs)

        def run(*xs):
            out, grads = inner(*xs)
            jax.debug.callback(lambda g: recorded.append(jax.tree_util.tree_map(np.asarray, g)),
                               grads)
            return out, grads
        return run

    jax_trainer_mod.mp_value_and_grad = recording
    try:
        step = jax.jit(t.train_step_fn).lower(t.state, b, t.rng).compile(
            compiler_options=COMPILE_OPTIONS)
    finally:
        jax_trainer_mod.mp_value_and_grad = value_and_grad
    state, out = t.state, []
    for _ in range(steps):
        state, metrics = step(state, b, t.rng)
        jax.block_until_ready(state)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                        grads=carry(recorded[-1]),
                        params=carry(jax.tree_util.tree_map(np.asarray,
                                                            state.params["model"]))))
    out[-1]["jax_params"] = state.params["model"]
    return out


def port_generic_run(model, pcfg, batch, want, teacher_forced: bool, out_dir: str):
    """The port's ``Trainer`` generic step, once a step of ``want``; with
    ``teacher_forced`` each update applies the JAX step's gradients. Per
    step: gradients and parameters by name, metrics. Returns the trainer
    and the steps."""
    t = Trainer(TrainerArgs(), copy.deepcopy(pcfg), out_dir, model, [], device="cpu")
    names = [n for n, _ in model.module.named_parameters()]
    apply, out = t.state.apply_updates, []

    def capture(grads):
        out[-1]["grads"] = dict(zip(names, (g.clone() for g in grads["model"])))
        if teacher_forced:
            grads = {"model": [want[len(out) - 1]["grads"][n] for n in names]}
        return apply(grads)

    t.state.apply_updates = capture
    tb = to_torch(batch)
    for _ in want:
        out.append({})
        t.state, metrics = t.train_step_fn(t.state, tb)
        out[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
        out[-1]["params"] = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    return t, out


def assert_steps_match(got, want, loss_tol, grad_tol, param_tol, zero_grads=()):
    """Per step: every metric within ``loss_tol`` of its value, every
    gradient within ``grad_tol`` of its tensor's peak or of the largest
    peak in its top-level module, whichever is larger (a bias whose
    gradient is a sum of residuals that nearly cancel, as the pitch
    predictor's once it fits the mean, carries its module's absolute
    rounding; the names in ``zero_grads`` exactly 0 on both sides), every
    parameter within ``param_tol``. Returns the largest errors seen."""
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        module_peak = {}
        for name, wg in w["grads"].items():
            top = name.split(".")[0]
            module_peak[top] = max(module_peak.get(top, 0.0), float(wg.abs().max()))
        assert set(g["metrics"]) == set(w["metrics"]), (sorted(g["metrics"]),
                                                        sorted(w["metrics"]))
        for k, v in w["metrics"].items():
            err = abs(g["metrics"][k] - v) / max(abs(v), 1e-6)
            worst["loss"] = max(worst["loss"], err)
            assert err <= loss_tol, (i, k, g["metrics"][k], v)
        assert set(g["grads"]) == set(w["grads"])
        for name, wg in w["grads"].items():
            got_g = g["grads"][name]
            if name in zero_grads:
                assert not wg.any() and not got_g.any(), name
                continue
            scale = max(float(wg.abs().max()), module_peak[name.split(".")[0]], 1e-30)
            err = float((got_g - wg).abs().max()) / scale
            worst["grad"] = max(worst["grad"], err)
            assert err <= grad_tol, (i, name, err)
        for name, p in w["params"].items():
            err = float((g["params"][name] - p).abs().max())
            worst["param"] = max(worst["param"], err)
            assert err <= param_tol, (i, name, err)
    return worst
