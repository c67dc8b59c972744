"""The port's VITS GAN step (``tts_tpu_torch.models.vits.train``) against the
JAX package's (``tts_tpu.models.vits.train``) on the CPU: losses, both
groups' gradients and the parameters after three AdamW steps with
ExponentialLR (the recipe's optimizer: lr 2e-4, betas (0.8, 0.99), eps
1e-9, weight decay 0.01, clip 1000), with the stochastic duration
predictor. ``tests/test_torch_vits_train_step_dp.py`` runs one step of the
``use_sdp=False`` model.

The configuration, batch and draws are ``tests/test_torch_vits_train.py``'s
(dropout 0; the JAX step's normals and uniforms recorded inside its jitted
step by ``jax.debug.callback`` and replayed by shape; its gradients caught
the same way around ``mp_value_and_grad``).

Tolerances:
- the losses within 1e-5 of each value, the duration NLL within 5e-5
  (``SDP_NLL_TOL``: fp32 rounding of its terms, see there);
- every gradient tensor within 1e-4 of its peak, those of the stochastic
  duration predictor within 3e-4 (``SDP_GRAD_TOL``): its NLL cancels terms
  ~25x its value, and on this batch a float64 evaluation of the port's
  duration loss puts both fp32 gradients ~1e-4 of their peaks from the exact
  ones (the JAX step's up to 1.07e-4, the port's up to 0.88e-4), so the two
  differ by up to ~2e-4 (measured 1.5e-4). The key projections'
  biases (``conv_k.bias``) of the text encoder's attention have zero
  gradient in exact arithmetic (a bias on every key adds the same score to
  a query's row, which the softmax removes); both packages give rounding
  noise there, and each is held to be noise: below 1e-6 of the group's peak;
- the parameters after each step within 1e-6, when the port's optimizer
  applies the JAX step's gradients (``teacher_forced``): the optimizer,
  schedule and clip agree to rounding. Left to its own gradients the port
  moves some elements differently: Adam divides each gradient element by
  its own root mean square, so a gradient element whose fp32 rounding
  differs in sign or size (the zero-gradient biases; small elements of the
  duration flows, whose gradients agree only within 1e-4 of the tensor's
  peak) moves by up to ~1.5 lr a step whatever its size. Free-running, the
  parameters are held within 3 steps x 1.5 lr = 9e-4.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vits_train import (
    SDP_NLL_TOL,
    recorded_jax_draws,
    replayed_draws,
    torch_batch,
    train_batch,
    train_pair,
)

import tts_tpu.models.vits.train as jax_train
from tts_tpu.trainer.state import TrainState as JaxTrainState
from tts_tpu_torch.models.vits import train as port_train
from tts_tpu_torch.utils.convert import flax_to_state_dict

GRAD_TOL = 1e-4  # of each tensor's peak
SDP_GRAD_TOL = 3e-4  # the stochastic duration predictor's (see the docstring)
PARAM_TOL = 1e-6  # absolute, teacher-forced
FREE_TOL = 9e-4  # absolute, free-running (3 steps x 1.5 lr)
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LOSSES = ("loss_disc", "loss_mel", "loss_kl", "loss_feat", "loss_gen", "loss_duration")


@contextlib.contextmanager
def recorded_jax_grads():
    """The JAX step's ``(gen, disc)`` gradients, from inside its jit."""
    grads = []
    orig = jax_train.mp_value_and_grad

    def recording(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def wrapped(*a):
            out, g = fn(*a)
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return out, g
        return wrapped

    jax_train.mp_value_and_grad = recording
    try:
        yield grads
    finally:
        jax_train.mp_value_and_grad = orig


def jax_steps(jm, jcfg, gen_params, disc_params, batch, n):
    """``n`` jitted JAX steps: per step its draws, gradients (as port state
    dicts), metrics and the parameters after it (as port state dicts)."""
    state = JaxTrainState.create({"gen": gen_params, "disc": disc_params},
                                 jax_train.make_optimizers(jcfg))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    steps = []
    with recorded_jax_draws() as draws, recorded_jax_grads() as grads:
        # LLVM's cheap settings: a third less compile time, the same HLO
        step = jax.jit(jax_train.make_train_step(jm, jcfg)[0]).lower(
            state, b, jax.random.PRNGKey(7)).compile(compiler_options=COMPILE_OPTIONS)
        for _ in range(n):
            state, metrics = step(state, b, jax.random.PRNGKey(7))
            metrics = {k: float(v) for k, v in metrics.items()}
            jax.effects_barrier()
            g = grads.pop()
            steps.append(dict(
                draws={k: list(v) for k, v in draws.items()},
                grads={"gen": flax_to_state_dict(g[0]), "disc": flax_to_state_dict(g[1])},
                metrics=metrics,
                params={k: flax_to_state_dict(state.params[k]) for k in ("gen", "disc")}))
            for v in draws.values():
                v.clear()
    return steps


def port_steps(port, pcfg, batch, jax_run, teacher_forced: bool):
    """The port's step on the JAX run's draws; with ``teacher_forced`` each
    step's update applies the JAX gradients. Per step: the port's gradients
    (by name), its metrics and its parameters after the step."""
    step, _, state = port.make_train_step(pcfg, torch.Generator(), device="cpu")
    names = port_train.param_names(port)
    apply = state.apply_updates
    out = []

    def capture(grads):
        out[-1]["grads"] = {k: dict(zip(names[k], (g.clone() for g in grads[k])))
                            for k in grads}
        if teacher_forced:
            ref = jax_run[len(out) - 1]["grads"]
            grads = {k: [ref[k][n] for n in names[k]] for k in grads}
        return apply(grads)

    state.apply_updates = capture
    tb = torch_batch(batch)
    for j in jax_run:
        out.append({})
        with replayed_draws(j["draws"]):
            state, metrics = step(state, tb)
        out[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
        out[-1]["params"] = {k: dict(zip(names[k], (p.detach().clone() for p in state.params[k])))
                             for k in ("gen", "disc")}
    return out


def check_losses(got, want, use_sdp=True):
    for k in LOSSES:
        tol = SDP_NLL_TOL if (k == "loss_duration" and use_sdp) else 1e-5
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), (k, got[k], want[k])


def check_grads(got, want, sdp=True):
    """Each tensor within ``GRAD_TOL`` of its peak (``SDP_GRAD_TOL`` for the
    stochastic duration predictor's); the attention key biases (zero in
    exact arithmetic) below 1e-6 of the group's peak."""
    for group in ("gen", "disc"):
        peak = max(float(w.abs().max()) for w in want[group].values())
        assert set(got[group]) == set(want[group])
        for name, w in want[group].items():
            g = got[group][name]
            if name.endswith("conv_k.bias"):
                assert float(w.abs().max()) < 1e-6 * peak and float(g.abs().max()) < 1e-6 * peak
                continue
            tol = SDP_GRAD_TOL if name.startswith("duration_predictor.") and sdp else GRAD_TOL
            err = float((g - w).abs().max())
            assert err <= tol * float(w.abs().max()), (group, name, err, float(w.abs().max()))


@pytest.fixture(scope="module")
def run():
    jm, gen_params, disc_params, port, pcfg = train_pair(True)
    batch = train_batch()
    return port, pcfg, gen_params, batch, jax_steps(jm, jm.config, gen_params, disc_params,
                                                    batch, 3)


def test_three_steps_teacher_forced(run):
    """The first step's gradients; the losses of every step; the parameters
    after each step within 1e-6 when the port's optimizer applies the JAX
    step's gradients."""
    port, pcfg, _, batch, jax_run = run
    got = port_steps(copy.deepcopy(port), pcfg, batch, jax_run, teacher_forced=True)
    check_grads(got[0]["grads"], jax_run[0]["grads"])
    for i, (g, j) in enumerate(zip(got, jax_run)):
        check_losses(g["metrics"], j["metrics"])
        for group in ("gen", "disc"):
            for name, want in j["params"][group].items():
                err = float((g["params"][group][name] - want).abs().max())
                assert err <= PARAM_TOL, (i, group, name, err)


def test_three_steps_free_running(run):
    """The port on its own gradients: the parameters after three steps
    within 9e-4 of the JAX step's (Adam's per-element normalisation, see the
    module's docstring), the discriminator's within 1e-6; the generator
    moved."""
    port, pcfg, gen_params, batch, jax_run = run
    got = port_steps(copy.deepcopy(port), pcfg, batch, jax_run, teacher_forced=False)
    for group, tol in (("gen", FREE_TOL), ("disc", PARAM_TOL)):
        for name, want in jax_run[-1]["params"][group].items():
            err = float((got[-1]["params"][group][name] - want).abs().max())
            assert err <= tol, (group, name, err)
    moved = [float((got[-1]["params"]["gen"][n] - p).abs().max())
             for n, p in flax_to_state_dict(gen_params).items()]
    assert max(moved) > 1e-4


def test_schedule_decays_per_update(run):
    """ExponentialLR per update: the third update's rate is lr x gamma²; the
    recipe's clip is 1000 for both groups."""
    pcfg = run[1]
    optimizers = port_train.make_optimizers(pcfg)
    gamma = pcfg.lr_scheduler_gen_params["gamma"]
    for k in ("gen", "disc"):
        assert optimizers[k].learning_rate(2) == pytest.approx(2e-4 * gamma**2, rel=1e-12)
        assert optimizers[k].grad_clip == 1000.0 and optimizers[k].name == "adamw"
