"""ForwardTTS training in the port (``ForwardTTSModule.forward``,
``forward_tts_loss``, ``ForwardTTS.train_step`` through the trainer's
generic step) against the JAX package's ``train_step`` under the JAX
``Trainer``'s generic step, on the CPU, for FastPitch, FastSpeech,
FastSpeech2 and SpeedySpeech.

Small widths (hidden 32, 2 FFT layers of 2 heads or SpeedySpeech's 3
dilations, 16 mels), every dropout 0, flax parameters drawn from a seed
(``test_torch_forward_tts.draw_params``) with the aligner's convolutions at
unit gain (``unit_gain_aligner``: at the draw's 0.05 the aligner's
log-probabilities are flat within 1e-6, and MAS's path would turn on
rounding), carried by ``utils.convert.forward_tts_from_jax_params``, the
aligner with the rest. A batch of two unequal texts and mels, with
normalised pitch and energy as given (F60's normalisation happens in the
data pipeline: ``test_torch_acoustic_train_tts.py``). Three AdamW steps:
the losses within 1e-5 of their values, the gradients within 1e-4 of each
tensor's peak (or of its module's largest, for sums that cancel:
``torch_acoustic_cases.assert_steps_match``), the parameters after each
step within 1e-6 when the port applies the JAX gradients, within 3 x 1.5
lr on its own; MAS's durations equal.

Divergences, each named in its test:

* F61: the JAX step weighs the binary alignment loss by 1, its
  ``binary_loss_warmup_epochs`` unread; the port's weight is
  ``min(epochs_done / binary_loss_warmup_epochs, 1)``, set at each step's
  start (``test_f61_binary_loss_warmup``); parity passes one weight to both
  sides (1, and 0.25 through a patched JAX ``train_step``);
* F27: a ``d_vector_dim`` other than ``hidden_channels`` raises before
  anything is built (``test_f27_training_raises_alike``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_forward_tts import draw_params, small_config
from torch_acoustic_cases import (
    STEPS,
    acoustic_batch,
    assert_steps_match,
    jax_generic_run,
    port_generic_run,
    to_torch,
)

from tts_tpu.models.forward_tts import ForwardTTS as JaxForwardTTS
from tts_tpu.models.forward_tts import config as jax_config
from tts_tpu.models.forward_tts.model import forward_tts_loss as jax_forward_tts_loss
from tts_tpu_torch.models.forward_tts import ForwardTTS
from tts_tpu_torch.models.forward_tts import config as port_config
from tts_tpu_torch.utils.convert import (
    forward_tts_from_jax_params,
    forward_tts_train_state_from_jax_params,
)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of each tensor's peak
PARAM_TOL = 1e-6  # teacher-forced
LR = 1e-3
NO_DROPOUT = dict(duration_predictor_dropout_p=0.0, pitch_predictor_dropout_p=0.0,
                  energy_predictor_dropout_p=0.0)
FAMILIES = ["fast_pitch", "fast_speech", "fastspeech2", "speedy_speech"]


def train_config(module, model):
    config = small_config(module, model, **NO_DROPOUT)
    config.optimizer, config.lr, config.lr_scheduler = "AdamW", LR, None
    return config


def unit_gain_aligner(params, seed=0):
    """The aligner's convolution kernels redrawn N(0, 1/fan_in)."""
    rs = np.random.RandomState(seed)
    for leaf in params["params"]["aligner"].values():
        k = leaf["Conv_0"]["kernel"]
        fan_in = k.shape[0] * k.shape[1]
        leaf["Conv_0"]["kernel"] = (rs.randn(*k.shape) / np.sqrt(fan_in)).astype(np.float32)
    return params


def with_binary_weight(jm, weight):
    """The JAX model with its ``train_step`` weighing the binary alignment
    loss by ``weight`` (the JAX step passes none: F61)."""
    def train_step(params, batch, rngs=None, train=True):
        outputs = jm.forward(params, batch, train=train, rngs=rngs)
        losses = jax_forward_tts_loss(jm.config, outputs, batch, binary_loss_weight=weight)
        return losses["loss"], {**losses, "outputs": outputs}

    jm.train_step = train_step
    return jm


def case_batch(model):
    pitch = model in ("fast_pitch", "fastspeech2")
    return acoustic_batch(seed=1, pitch=pitch, energy=model == "fastspeech2")


@functools.lru_cache(maxsize=None)
def jax_case(model, weight=1.0):
    jcfg = train_config(jax_config, model)
    jm = JaxForwardTTS(jcfg)
    params = unit_gain_aligner(draw_params(jm, seed=3))
    if weight != 1.0:
        with_binary_weight(jm, weight)
    batch = case_batch(model)
    want = jax_generic_run(jm, jcfg, params, batch, forward_tts_from_jax_params)
    return jm, jcfg, params, batch, want


def port_model(jcfg, params, weight=1.0):
    pcfg = port_config.__dict__[type(jcfg).__name__].from_dict(jcfg.to_dict())
    model = ForwardTTS(pcfg)
    model.load_state_dict(forward_tts_from_jax_params(params))
    model.binary_loss_weight = weight
    return model, pcfg


@pytest.mark.parametrize("model", FAMILIES)
def test_steps_match_the_jax_trainer(model, tmp_path):
    """Three teacher-forced steps: every loss, ``grad_norm``, the gradients
    (the aligner's among them) and the parameters after each step; then the
    durations MAS found and the outputs on the JAX step's first weights."""
    jm, jcfg, params, batch, want = jax_case(model)
    port, pcfg = port_model(jcfg, params)
    _, got = port_generic_run(port, pcfg, batch, want, True, str(tmp_path))
    worst = assert_steps_match(got, want, LOSS_TOL, GRAD_TOL, PARAM_TOL)
    print(model, worst)
    assert set(want[0]["metrics"]) >= {"loss_aligner", "loss_binary_alignment", "loss_dur"}
    # the first step's pass: MAS's durations and the masked -1e9 scores it read
    jout = jm.forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
    port.load_state_dict(forward_tts_from_jax_params(params))
    with torch.no_grad():
        pout = port.train_step(to_torch(batch), torch.Generator(), train=False)[1]["outputs"]
    np.testing.assert_array_equal(pout["o_alignment_dur"].numpy(),
                                  np.asarray(jout["o_alignment_dur"]))
    np.testing.assert_array_equal(pout["alignment_mas"].numpy(),
                                  np.asarray(jout["alignment_mas"]))
    for key in ("model_outputs", "alignment_soft", "pitch_avg_gt", "energy_avg_gt"):
        if jout[key] is not None:
            np.testing.assert_allclose(pout[key].numpy(), np.asarray(jout[key]), atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("model", ["fast_pitch", "speedy_speech"])
def test_steps_on_the_ports_own_gradients(model, tmp_path):
    """The port on its own gradients: parameters within 3 x 1.5 lr of the
    JAX run's after three steps; the evaluation (``train=False``) of the
    last weights equals the JAX model's loss."""
    jm, jcfg, params, batch, want = jax_case(model)
    port, pcfg = port_model(jcfg, params)
    t, got = port_generic_run(port, pcfg, batch, want, False, str(tmp_path))
    for name, p in want[-1]["params"].items():
        err = float((got[-1]["params"][name] - p).abs().max())
        assert err <= STEPS * 1.5 * LR, (name, err)
    port.load_state_dict({n: p.clone() for n, p in want[-1]["params"].items()})
    got_eval = t.eval_step_fn(t.state, to_torch(batch))
    jloss, jaux = jm.train_step(want[-1]["jax_params"],
                                {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    assert set(got_eval) == {k for k in jaux if k != "outputs"}
    for k, v in got_eval.items():
        assert abs(float(v) - float(jaux[k])) <= LOSS_TOL * abs(float(jaux[k])), k


def test_f61_binary_weight_passed_to_both(tmp_path):
    """F61's weight, 0.25 on both sides: the losses, gradients and
    parameters agree as at weight 1."""
    jm, jcfg, params, batch, want = jax_case("fast_pitch", 0.25)
    port, pcfg = port_model(jcfg, params, weight=0.25)
    _, got = port_generic_run(port, pcfg, batch, want, True, str(tmp_path))
    assert_steps_match(got, want, LOSS_TOL, GRAD_TOL, PARAM_TOL)
    full = jax_case("fast_pitch")[4][0]["metrics"]
    m = want[0]["metrics"]
    assert abs((full["loss"] - m["loss"])
               - 0.75 * jcfg.binary_align_loss_alpha * m["loss_binary_alignment"]) <= 1e-5


def test_f61_binary_loss_warmup():
    """F61: the port's weight at a step's start is ``min(epochs_done /
    binary_loss_warmup_epochs, 1)`` (the reference's schedule); the JAX
    config's field is read by nothing, so the JAX weight is 1 always."""
    import inspect

    import tts_tpu.models.forward_tts.model as jax_model_mod

    assert "binary_loss_warmup_epochs" not in inspect.getsource(jax_model_mod)
    port, _ = port_model(train_config(jax_config, "fast_pitch"),
                         unit_gain_aligner(draw_params(JaxForwardTTS(
                             train_config(jax_config, "fast_pitch")), seed=3)))
    port.config.binary_loss_warmup_epochs = 4
    for epochs_done, weight in ((0, 0.0), (1, 0.25), (3, 0.75), (4, 1.0), (9, 1.0)):
        port.on_train_step_start(SimpleNamespace(epochs_done=epochs_done))
        assert port.binary_loss_weight == weight
    port.config.binary_loss_warmup_epochs = 0
    port.on_train_step_start(SimpleNamespace(epochs_done=0))
    assert port.binary_loss_weight == 1.0


def test_f27_training_raises_alike():
    """F27: a ``d_vector_dim`` other than ``hidden_channels`` raises before
    anything is built, so no training step runs on it."""
    config = train_config(port_config, "fast_pitch")
    config.use_d_vector_file, config.d_vector_dim = True, 48
    with pytest.raises(NotImplementedError, match="F27"):
        ForwardTTS(config)


def test_train_state_and_reference_layout_keep_the_aligner(tmp_path):
    """A JAX ``{"model": params}`` train state comes across with the
    aligner; the reference layout keeps ``aligner.*`` (its
    ``key_layer``/``query_layer`` names) and loads back bit for bit, and
    ``--restore_path`` on such a file copies every tensor."""
    from tts_tpu_torch.utils.convert import (
        load_reference_forward_tts,
        reference_forward_tts_state,
    )

    jm, jcfg, params, _, _ = jax_case("fast_pitch")
    state = forward_tts_train_state_from_jax_params({"model": params})["model"]
    port, _ = port_model(jcfg, params)
    assert set(state) == set(port.module.state_dict())
    assert any(k.startswith("aligner.query_conv3") for k in state)
    ref = reference_forward_tts_state(port.module.state_dict())
    assert {"aligner.key_layer.0.weight", "aligner.key_layer.2.weight",
            "aligner.query_layer.4.bias"} <= set(ref)
    back = load_reference_forward_tts(ref, port.args)
    for k, v in port.module.state_dict().items():
        assert torch.equal(back[k], v), k
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ref.items()}},
               tmp_path / "model_file.pth")
    fresh = ForwardTTS(copy.deepcopy(port.config)).load_checkpoint(
        port.config, checkpoint_path=str(tmp_path / "model_file.pth"), device="cpu")
    for k, v in port.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v), k
    # --restore_path on the reference file: every tensor copied, the aligner's too
    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs

    model = ForwardTTS(copy.deepcopy(port.config))
    t = Trainer(TrainerArgs(restore_path=str(tmp_path / "model_file.pth")),
                copy.deepcopy(port.config), str(tmp_path / "run"), model, [], device="cpu")
    assert t.partial_restore == (len(port.module.state_dict()), 0)
    for k, v in port.module.state_dict().items():
        assert torch.equal(model.module.state_dict()[k], v), k
