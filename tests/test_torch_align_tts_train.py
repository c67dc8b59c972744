"""AlignTTS training in the port (the MDN head, ``compute_log_probs``,
``mdn_loss``, MAS, ``align_tts_loss``, ``AlignTTS.train_step`` through the
trainer's generic step) against the JAX package's, on the CPU, in every
phase.

Small widths (``test_torch_align_tts.small_config``: hidden 32, 2 FFT
layers of 2 heads, 16 mels; the conv blocks train in SpeedySpeech's test), flax
parameters drawn from a seed (the MDN head among them), carried by
``utils.convert.align_tts_from_jax_params``. Every dropout is 0: the
blocks' through the config, and the duration predictor's and the MDN's,
which both packages hard-wire at 0.1, by running the JAX model with
``train=False`` (``with_phase``) and setting the port's to 0. Three AdamW
steps under the JAX ``Trainer``'s generic step: the losses within 1e-5,
the gradients within 1e-4 of each tensor's peak (or its module's), the
parameters within 1e-6 when the port applies the JAX gradients; MAS's path
equal. ``mdn_loss``'s loop over the frames against the JAX ``lax.scan``
on its own, the value within 1e-5 and the gradient within 1e-4.

Divergences, each named in its test:

* F62, settled in the port: the JAX step always trains in phase -1,
  ``phase_start_steps`` unread; the port sets the phase at each epoch's
  start from it and the steps done (``test_f62_phase_schedule``); the
  steps are compared in phases -1 and 0-3, the phase given to both sides;
* F64, kept: ``mod_layer``'s gradient is exactly 0 in both packages, its
  only output reaching the duration predictor through a stop-gradient
  (``test_steps_match_the_jax_trainer``'s ``zero_grads``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_align_tts import jax_pair
from torch_acoustic_cases import (
    acoustic_batch,
    assert_steps_match,
    jax_generic_run,
    port_generic_run,
    to_torch,
)

from tts_tpu.models.align_tts.model import align_tts_loss as jax_align_tts_loss
from tts_tpu.models.align_tts.model import mdn_loss as jax_mdn_loss
from tts_tpu_torch.models.align_tts import AlignTTS, AlignTTSConfig
from tts_tpu_torch.models.align_tts.model import mdn_loss, training_phase
from tts_tpu_torch.utils.convert import (
    align_tts_from_jax_params,
    align_tts_train_state_from_jax_params,
)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
LR = 1e-3
F64 = ("mod_layer.weight", "mod_layer.bias")
PHASES = [-1, 0, 1, 2, 3]


def with_phase(jm, phase):
    """The JAX model's ``train_step`` in ``phase`` (its own always runs -1:
    F62), the hard-wired dropouts off (``train=False``)."""
    def train_step(params, batch, rngs=None, train=True):
        outputs = jm.forward(params, batch, train=False, rngs=rngs, phase=phase)
        losses = jax_align_tts_loss(jm.config, outputs, batch, phase=phase)
        return losses["loss"], {**losses, "outputs": outputs}

    jm.train_step = train_step
    return jm


@functools.lru_cache(maxsize=None)
def jax_case(phase):
    jm, params, _ = jax_pair(seed=5)
    jm.config.optimizer, jm.config.lr, jm.config.lr_scheduler = "AdamW", LR, None
    with_phase(jm, phase)
    batch = acoustic_batch(seed=3)
    want = jax_generic_run(jm, jm.config, params, batch, align_tts_from_jax_params)
    return jm, params, batch, want


def port_model(jm, params, phase):
    model = AlignTTS(AlignTTSConfig.from_dict(jm.config.to_dict()))
    model.load_state_dict(align_tts_from_jax_params(params))
    model.module.duration_predictor.dropout.p = model.module.mdn_dropout.p = 0.0
    model.phase = phase
    return model


@pytest.mark.parametrize("phase", PHASES)
def test_steps_match_the_jax_trainer(phase, tmp_path):
    """Three teacher-forced steps in ``phase``: the four losses and their
    weighted sum, ``grad_norm``, the gradients (``mod_layer``'s exactly 0 on
    both sides: F64) and the parameters after each; then, in phase -1,
    MAS's path and its input."""
    jm, params, batch, want = jax_case(phase)
    port = port_model(jm, params, phase)
    _, got = port_generic_run(port, port.config, batch, want, True, str(tmp_path))
    print(phase, assert_steps_match(got, want, LOSS_TOL, GRAD_TOL, PARAM_TOL,
                                           zero_grads=F64))
    assert set(want[0]["metrics"]) == {"loss", "loss_mdn", "loss_spec", "loss_ssim",
                                       "loss_dur", "grad_norm"}
    if phase != -1:  # the phase changes no MAS input
        return
    port.load_state_dict(align_tts_from_jax_params(params))
    with torch.no_grad():
        pout = port.train_step(to_torch(batch), torch.Generator(), train=False)[1]["outputs"]
    jout = jax.jit(lambda p, b: jm.forward(p, b, phase=phase))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(pout["alignments"].numpy(), np.asarray(jout["alignments"]))
    np.testing.assert_allclose(pout["logp"].numpy(), np.asarray(jout["logp"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_mdn_loss_loop_against_the_scan(seed):
    """``mdn_loss``, a loop over the frames, against the JAX ``lax.scan``:
    the value within 1e-5 and the gradient w.r.t. the log-probabilities
    within 1e-4 of its peak (40 log-adds of fp32 rounding: 1.2e-5 seen),
    rows of unequal lengths."""
    rs = np.random.RandomState(seed)
    logp = (rs.randn(3, 10, 40) * 3 - 5).astype(np.float32)
    tl, ml = np.asarray([10, 7, 4], np.int32), np.asarray([40, 29, 12], np.int32)
    jv, jg = jax.value_and_grad(jax_mdn_loss)(jnp.asarray(logp), jnp.asarray(tl), jnp.asarray(ml))
    t = torch.from_numpy(logp).requires_grad_(True)
    pv = mdn_loss(t, torch.from_numpy(tl), torch.from_numpy(ml))
    (pg,) = torch.autograd.grad(pv, [t])
    assert abs(float(pv.detach()) - float(jv)) <= LOSS_TOL * abs(float(jv))
    assert float((pg - torch.from_numpy(np.array(jg))).abs().max()) <= \
        GRAD_TOL * float(np.abs(np.asarray(jg)).max())


def test_f62_phase_schedule():
    """F62: the port's phase at an epoch's start, from ``phase_start_steps``
    and the steps done (the reference's ``_set_phase``); ``None`` keeps -1.
    The JAX ``train_step`` passes no phase, so it always runs -1."""
    import inspect

    from tts_tpu.models.align_tts.model import AlignTTS as JaxAlignTTS

    src = inspect.getsource(JaxAlignTTS.train_step)
    assert "phase" not in src.replace("def train_step", "")
    starts = [0, 40, 80, 160]
    for step, phase in ((0, 0), (1, 0), (40, 0), (41, 1), (81, 2), (160, 2), (161, 3),
                        (10**6, 3)):
        assert training_phase(starts, step) == phase, step
    assert training_phase(None, 500) == -1
    config = AlignTTSConfig(phase_start_steps=starts)
    config.model_args.num_chars, config.model_args.hidden_channels = 40, 32
    config.model_args.encoder_params["num_layers"] = 1
    config.model_args.decoder_params["num_layers"] = 1
    model = AlignTTS(config)
    model.on_epoch_start(SimpleNamespace(global_step=41))
    assert model.phase == 1
    model.on_epoch_start(SimpleNamespace(global_step=0))
    assert model.phase == 0


def test_train_state_carries_the_mdn_head():
    """A JAX ``{"model": params}`` train state comes across with the MDN
    head (``mdn_conv1``, ``mdn_norm``, ``mdn_conv2``)."""
    jm, params, _, _ = jax_case(-1)
    state = align_tts_train_state_from_jax_params({"model": params})["model"]
    port = port_model(jm, params, -1)
    assert set(state) == set(port.module.state_dict())
    assert {"mdn_conv1.weight", "mdn_norm.weight", "mdn_norm.bias", "mdn_conv2.bias"} <= \
        set(state)
    for k, v in port.module.state_dict().items():
        assert torch.equal(state[k], v), k
