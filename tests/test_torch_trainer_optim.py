"""The port's schedules and optimizers (``tts_tpu_torch.trainer.optim``,
``trainer.state``) against the JAX package's (``tts_tpu.trainer.optim``,
optax) on the same gradients, on the CPU.

Schedules: NoamLR, ExponentialLR (with and without ``steps_per_epoch``),
StepLR, StepwiseGradualLR and a constant, read at the same update counts,
within 1e-6 of each value (optax computes them in fp32). Optimizers:
AdamW, Adam, RAdam (past its rectification threshold), SGD with momentum
and RMSprop, each wrapped as the JAX package wraps it: a global-norm clip
(gradients above and below the norm), gradient accumulation over 3 calls
(``optax.MultiSteps``) and the skip of non-finite gradients
(``optax.apply_if_finite``). The same seeded gradients go to both for 8
calls; the parameters must agree within 1e-6 absolute (fp32; the learning
rates are 1e-2, so a step moves a parameter ~1e-2).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tts_tpu.trainer import optim as jax_optim
from tts_tpu_torch.trainer import optim
from tts_tpu_torch.trainer.state import TrainState

SCHEDULES = [
    (None, {}),
    ("NoamLR", {"warmup_steps": 4}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("ExponentialLR", {"gamma": 0.8, "steps_per_epoch": 3}),
    ("StepLR", {"step_size": 3, "gamma": 0.5}),
    ("StepwiseGradualLR", {"gradual_learning_rates": [[0, 1e-2], [3, 5e-3], [6, 1e-3]]}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[str(s[0]) + str(len(s[1]))
                                                        for s in SCHEDULES])
def test_schedules(name, params):
    want = jax_optim.build_lr_schedule(name, 1e-2, params)
    got = optim.build_lr_schedule(name, 1e-2, params)
    for step in range(12):
        w = float(want(jnp.asarray(step, jnp.int32))) if callable(want) else want
        g = got(step) if callable(got) else got
        assert g == pytest.approx(w, rel=1e-6, abs=1e-12), (step, g, w)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        optim.build_lr_schedule("cosine", 1e-3)
    with pytest.raises(ValueError):
        optim.build_optimizer("lamb", 1e-3)


SHAPES = [(4, 3), (5,), (2, 2, 3)]


def gradients(calls: int, scale: float, seed: int = 0, nan_at=()):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(calls):
        gs = [(rs.randn(*s) * scale).astype(np.float32) for s in SHAPES]
        if i in nan_at:
            gs[1][2] = np.nan
        out.append(gs)
    return out


def run_both(name, opt_params, grads, lr=1e-2, clip=0.0, accum=1, skip_nf=False,
             schedule=None):
    """The same gradients through optax (the JAX package's chain) and the
    port; returns both parameter lists after every call."""
    rs = np.random.RandomState(42)
    init = [(rs.randn(*s) * 0.5).astype(np.float32) for s in SHAPES]
    j_lr = jax_optim.build_lr_schedule(schedule, lr, {"gamma": 0.9}) if schedule else lr
    p_lr = optim.build_lr_schedule(schedule, lr, {"gamma": 0.9}) if schedule else lr
    tx = jax_optim.build_optimizer(name, j_lr, dict(opt_params), clip, accum, skip_nf)
    j_params = [jnp.asarray(p) for p in init]
    j_state = tx.init(j_params)
    spec = optim.build_optimizer(name, p_lr, dict(opt_params), clip, accum, skip_nf)
    p_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    state = TrainState.create({"g": p_params}, {"g": spec})
    j_hist, p_hist = [], []
    for gs in grads:
        updates, j_state = tx.update([jnp.asarray(g) for g in gs], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        state.apply_updates({"g": [torch.from_numpy(g) for g in gs]})
        j_hist.append([np.asarray(p) for p in j_params])
        p_hist.append([p.detach().numpy().copy() for p in p_params])
    return j_hist, p_hist, state


def assert_same(j_hist, p_hist, tol=1e-6):
    for i, (js, ps) in enumerate(zip(j_hist, p_hist)):
        for j, p in zip(js, ps):
            np.testing.assert_allclose(p, j, rtol=0, atol=tol, err_msg=f"call {i}")


OPTIMIZERS = {
    "adamw": {"betas": [0.8, 0.99], "eps": 1e-9, "weight_decay": 0.01},
    "adam": {"betas": [0.9, 0.98], "eps": 1e-8},
    "radam": {"betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.1},
    "sgd": {"momentum": 0.9},
    "rmsprop": {"alpha": 0.95, "eps": 1e-6},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    calls = 12 if name == "radam" else 8  # RAdam rectifies from its 6th update
    j, p, _ = run_both(name, OPTIMIZERS[name], gradients(calls, 0.1),
                       schedule="ExponentialLR")
    assert_same(j, p)
    assert not np.allclose(p[-1][0], p[0][0])


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_global_norm_clip(scale):
    """optax's clip: ``g / norm * max`` once the norm reaches ``max`` (here
    1.0; the gradients' norm is ~0.04 or ~40)."""
    j, p, _ = run_both("sgd", {"momentum": 0.0}, gradients(4, scale, seed=1), lr=0.1, clip=1.0)
    assert_same(j, p)


def test_accumulation_every_third_call():
    """MultiSteps: parameters move on calls 3, 6 (the mean of the last
    three gradients), and not in between."""
    j, p, state = run_both("adamw", OPTIMIZERS["adamw"], gradients(7, 0.1, seed=2), accum=3,
                           schedule="ExponentialLR", clip=0.5)
    assert_same(j, p)
    assert np.array_equal(p[0][0], p[1][0]) and not np.array_equal(p[1][0], p[2][0])
    assert state.opt_states["g"].count == 2 and state.opt_states["g"].mini_step == 1


def test_non_finite_gradients_are_skipped():
    """A call with a NaN changes neither the parameters nor the optimizer's
    state (its count, the schedule's step, accumulated gradients)."""
    grads = gradients(8, 0.1, seed=3, nan_at=(2, 5))
    j, p, state = run_both("adamw", OPTIMIZERS["adamw"], grads, skip_nf=True, accum=2,
                           schedule="ExponentialLR")
    assert_same(j, p)
    assert np.array_equal(p[1][0], p[2][0])
    assert state.opt_states["g"].count == 3 and state.step == 8


def test_schedule_is_read_before_the_update():
    """optax reads the schedule at the count of updates already applied:
    the first update uses ``lr(0)``."""
    seen = []
    spec = optim.build_optimizer("sgd", lambda n: seen.append(n) or 0.1)
    params = [torch.nn.Parameter(torch.zeros(3))]
    st = spec.init(params)
    for _ in range(3):
        st.update([torch.ones(3)])
    assert seen == [0, 1, 2] and torch.allclose(params[0], torch.full((3,), -0.3))
