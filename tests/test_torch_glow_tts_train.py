"""GlowTTS training in the port (``GlowTTSModule.forward``: the flow decoder
in the forward direction with its log-determinant, ``_mas_logp`` and MAS;
``glow_tts_loss``; ``GlowTTS.train_step`` through the trainer's generic
step) against the JAX package's ``train_step`` under the JAX ``Trainer``'s
generic step, on the CPU.

Tiny widths (``test_torch_glow_tts.tiny_glow_kw``: hidden 32, 2 flow blocks
of 2 WaveNet layers, 16 mels), flax parameters drawn from a seed with each
``InvConvNear`` orthogonal (``tiny_jax_glow``), carried by
``utils.convert.glow_tts_from_jax_params``. Every dropout is 0: the
configs' (``dropout_p_dp``, ``dropout_p_dec``, the encoder's), and the
prenet's, which both packages hard-wire at 0.5 (``no_prenet_dropout``
builds the JAX prenet at 0 under its own name; the port's is set to 0).
Cases: the mean-only prior (the recipe's), learned log-scales, and three
speakers through ``emb_g``. Three AdamW steps: the losses within 1e-5,
the gradients (``InvConvNear``'s log-determinant among them) within 1e-4
of each tensor's peak (or its module's), the parameters within 1e-6 when
the port applies the JAX gradients, within 3 x 1.5 lr on its own; MAS's
path equal.

F63, kept as the JAX package has it (``test_f63_actnorm_identity_and_no_data_init``):
``data_dep_init_steps`` is read by neither package and ``ActNorm`` starts
at the identity, in the trainer's weights too.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import tiny_jax_glow
from torch_acoustic_cases import (
    STEPS,
    acoustic_batch,
    assert_steps_match,
    jax_generic_run,
    port_generic_run,
    to_torch,
)

import tts_tpu
import tts_tpu.models.glow_tts.model as jax_glow_model
from tts_tpu.layers.common import ConvLayerNormBlock as JaxConvLayerNormBlock
from tts_tpu_torch.layers.glow import ActNorm
from tts_tpu_torch.models.glow_tts.config import GlowTTSConfig
from tts_tpu_torch.models.glow_tts.model import GlowTTS
from tts_tpu_torch.utils.convert import (
    glow_tts_from_jax_params,
    glow_tts_train_state_from_jax_params,
)

READ = re.compile(r"\.data_dep_init_steps|[\"']data_dep_init_steps[\"']")  # a read, not a field
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
LR = 1e-3
CASES = {
    "mean_only": dict(),
    "log_scales": dict(mean_only=False),
    "speakers": dict(num_speakers=3, use_speaker_embedding=True),
}


class NoDropoutPrenet(JaxConvLayerNormBlock):
    """The JAX prenet with its hard-wired 0.5 dropout at 0."""

    def __post_init__(self):
        object.__setattr__(self, "dropout_p", 0.0)
        super().__post_init__()


@contextlib.contextmanager
def no_prenet_dropout():
    saved = jax_glow_model.ConvLayerNormBlock
    jax_glow_model.ConvLayerNormBlock = NoDropoutPrenet
    try:
        yield
    finally:
        jax_glow_model.ConvLayerNormBlock = saved


def case_batch(name):
    batch = acoustic_batch(seed=2)
    if name == "speakers":
        batch["speaker_ids"] = np.asarray([2, 0], np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_case(name):
    kw = dict(CASES[name], num_chars=40, dropout_p_dp=0.0, dropout_p_dec=0.0)
    aux = {"speaker_ids": jnp.zeros((1,), jnp.int32)} if name == "speakers" else None
    jm, params = tiny_jax_glow(seed=4, aux=aux, **kw)
    jm.config.optimizer, jm.config.lr, jm.config.lr_scheduler = "AdamW", LR, None
    batch = case_batch(name)
    with no_prenet_dropout():
        want = jax_generic_run(jm, jm.config, params, batch, glow_tts_from_jax_params)
    return jm, params, batch, want


def port_model(jm, params):
    model = GlowTTS(GlowTTSConfig.from_dict(jm.config.to_dict()))
    model.load_state_dict(glow_tts_from_jax_params(params))
    model.module.enc.prenet.dropout.p = 0.0
    return model


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_the_jax_trainer(name, tmp_path):
    """Three teacher-forced steps: ``loss``, ``log_mle``, ``loss_dur``,
    ``grad_norm``, the gradients and the parameters after each; then MAS's
    path and the flow's latents and log-determinant on the first weights."""
    jm, params, batch, want = jax_case(name)
    port = port_model(jm, params)
    _, got = port_generic_run(port, port.config, batch, want, True, str(tmp_path))
    print(name, assert_steps_match(got, want, LOSS_TOL, GRAD_TOL, PARAM_TOL))
    assert set(want[0]["metrics"]) == {"loss", "log_mle", "loss_dur", "grad_norm"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with no_prenet_dropout():
        jout = jm.forward(params, jb)
    port.load_state_dict(glow_tts_from_jax_params(params))
    with torch.no_grad():
        pout = port.train_step(to_torch(batch), torch.Generator(), train=False)[1]["outputs"]
    np.testing.assert_array_equal(pout["alignments"].numpy(), np.asarray(jout["alignments"]))
    np.testing.assert_array_equal(pout["y_lengths"].numpy(), np.asarray(jout["y_lengths"]))
    for key in ("z", "logdet", "y_mean", "total_durations_log"):
        want_v = np.asarray(jout[key])
        np.testing.assert_allclose(pout[key].numpy(), want_v, rtol=0,
                                   atol=1e-5 * max(float(np.abs(want_v).max()), 1.0),
                                   err_msg=key)


def test_steps_on_the_ports_own_gradients(tmp_path):
    """The port on its own gradients: parameters within 3 x 1.5 lr of the
    JAX run's after three steps; the evaluation of the last weights equals
    the JAX model's loss."""
    jm, params, batch, want = jax_case("log_scales")
    port = port_model(jm, params)
    t, got = port_generic_run(port, port.config, batch, want, False, str(tmp_path))
    for name, p in want[-1]["params"].items():
        err = float((got[-1]["params"][name] - p).abs().max())
        assert err <= STEPS * 1.5 * LR, (name, err)
    port.load_state_dict({n: p.clone() for n, p in want[-1]["params"].items()})
    port.module.enc.prenet.dropout.p = 0.0
    got_eval = t.eval_step_fn(t.state, to_torch(batch))
    with no_prenet_dropout():
        _, jaux = jm.train_step(want[-1]["jax_params"],
                                {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    for k, v in got_eval.items():
        assert abs(float(v) - float(jaux[k])) <= LOSS_TOL * abs(float(jaux[k])), k


def test_dropouts_are_the_jax_packages():
    """The rates of every dropout the JAX GlowTTS applies in training: the
    prenet's 0.5, the transformer's, the duration predictor's and the
    couplings' WaveNets'."""
    config = GlowTTSConfig(num_chars=40, dropout_p_dp=0.2, dropout_p_dec=0.05,
                           encoder_params={"kernel_size": 3, "dropout_p": 0.15, "num_layers": 2,
                                           "num_heads": 2, "hidden_channels_ffn": 48},
                           num_flow_blocks_dec=2, num_block_layers=2)
    m = GlowTTS(config).module
    assert m.enc.prenet.dropout.p == 0.5
    assert m.enc.duration_predictor.dropout.p == 0.2
    assert m.enc.encoder.dropout.p == 0.15
    assert {f.wn.dropout.p for f in m.dec.flows() if hasattr(f, "wn")} == {0.05}


def test_f63_actnorm_identity_and_no_data_init(tmp_path):
    """F63: nothing in either package reads ``data_dep_init_steps``;
    ``ActNorm`` starts at the identity (zero log-scale and bias, a zero
    log-determinant), and so does each flow of the trainer's weights
    (``init_params`` with ``discriminator``: the coupling's ``end`` zero
    too); a generic step from those weights is the same at 0 and 10
    data-dependent steps."""
    import tts_tpu_torch

    for package in (tts_tpu, tts_tpu_torch):
        root = os.path.dirname(package.__file__)
        readers = []
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        if READ.search(fh.read()):
                            readers.append(f)
        assert readers == [], readers
    norm = ActNorm(8)
    x = torch.randn(2, 5, 8)
    z, logdet = norm(x)
    assert torch.equal(z, x) and torch.equal(logdet, torch.zeros(2))
    runs = []
    for steps in (0, 10):
        config = GlowTTSConfig(num_chars=40, out_channels=16, hidden_channels_enc=32,
                               hidden_channels_dec=24, hidden_channels_dp=32,
                               num_flow_blocks_dec=2, num_block_layers=2, dropout_p_dp=0.0,
                               dropout_p_dec=0.0, data_dep_init_steps=steps,
                               encoder_params={"kernel_size": 3, "dropout_p": 0.0,
                                               "num_layers": 2, "num_heads": 2,
                                               "hidden_channels_ffn": 48})
        model = GlowTTS(config)
        from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs

        t = Trainer(TrainerArgs(), config, str(tmp_path / str(steps)), model, [], device="cpu")
        for k in range(config.num_flow_blocks_dec):
            act = getattr(model.module.dec, f"actnorm_{k}")
            assert not act.logs.any() and not act.bias.any()
            assert not getattr(model.module.dec, f"coupling_{k}").end.weight.any()
        t.generator.manual_seed(0)
        _, metrics = t.train_step_fn(t.state, to_torch(case_batch("mean_only")))
        runs.append(({k: float(v) for k, v in metrics.items()},
                     [p.detach().clone() for p in model.module.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_state_carries_over():
    """A JAX ``{"model": params}`` train state comes across whole."""
    jm, params, _, _ = jax_case("mean_only")
    state = glow_tts_train_state_from_jax_params({"model": params})["model"]
    port = port_model(jm, params)
    assert set(state) == set(port.module.state_dict())
    for k, v in port.module.state_dict().items():
        assert torch.equal(state[k], v), k
