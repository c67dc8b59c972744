"""One VITS GAN step of the ``use_sdp=False`` model (the deterministic
duration predictor with its squared log-duration loss) in the port against
the JAX package's step, on the CPU: the losses within 1e-5 of each value,
both groups' gradients within 1e-4 of each tensor's peak (the attention key
biases, zero in exact arithmetic, held to be noise), and the parameters
after the step within 1e-6 when the port's optimizer applies the JAX step's
gradients. Configuration, draws and tolerances as in
``tests/test_torch_vits_train_step.py``, whose helpers this file uses.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

from test_torch_vits_train import train_batch, train_pair
from test_torch_vits_train_step import (
    PARAM_TOL,
    check_grads,
    check_losses,
    jax_steps,
    port_steps,
)


def test_one_step_matches_jax():
    jm, gen_params, disc_params, port, pcfg = train_pair(False)
    batch = train_batch(seed=1)
    jax_run = jax_steps(jm, jm.config, gen_params, disc_params, batch, 1)
    got = port_steps(port, pcfg, batch, jax_run, teacher_forced=True)
    check_losses(got[0]["metrics"], jax_run[0]["metrics"], use_sdp=False)
    check_grads(got[0]["grads"], jax_run[0]["grads"], sdp=False)
    assert "duration_predictor.conv_1.weight" in got[0]["grads"]["gen"]
    for group in ("gen", "disc"):
        for name, want in jax_run[0]["params"][group].items():
            err = float((got[0]["params"][group][name] - want).abs().max())
            assert err <= PARAM_TOL, (group, name, err)
