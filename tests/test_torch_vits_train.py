"""The port's VITS training forward (``VitsModule.forward``) and step
against the JAX package's, on the CPU at a small size; the bf16 autocast
step; the step's entry point and what it refuses.

Configuration (``train_configs``): ``test_torch_vits_model.tiny_vits_args``
cut to one layer a stack, one resblock kernel, periods (2, 3), a
discriminator at ``width_mult`` 1/16, 8-frame segments and a 16-sample hop
(fft 128, 20 mels). **Dropout is set to 0** in both packages' configs, so
that neither draws a mask (a ``torch.Generator`` cannot replay
``jax.random``); dropout's own tests are in
``tests/test_torch_vits_train_blocks.py``. The JAX parameters are
N(0, 0.1²) (``helpers.fast_params``), carried over by
``vits_from_jax_params`` and ``vits_discriminator_from_jax_params``.

The JAX draws (the posterior's and the duration posterior's normals, the
segment uniforms) are recorded from inside its jitted programs by
``jax.debug.callback`` and replayed into the port by shape through
``modules.normal`` and ``ops.helpers.uniform``, the functions the port draws
with. The alignments (K2's plain version here) and segment starts must be
identical; every other output and loss within 1e-5 of its peak, for
``use_sdp`` True and False.

F12 (ROADMAP.md): the JAX training forward feeds the duration predictor the
prior means ``m_p``, while its inference (and the reference) feeds it the
text encoder's output. The port keeps the JAX training behaviour;
``test_f12_training_feeds_the_prior_means`` names the divergence.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_params
from test_torch_vits_model import WEIGHT_SCALE, tiny_vits_args

from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu_torch.models.vits import Vits, VitsConfig, modules
from tts_tpu_torch.models.vits import train as port_train
from tts_tpu_torch.ops import helpers
from tts_tpu_torch.utils.convert import vits_discriminator_from_jax_params, vits_from_jax_params

TOL = 1e-5
# The stochastic duration predictor's NLL is a difference of per-row sums
# ~25x its value (the flows' and the posterior's terms, log-determinants
# included), so fp32 rounding of the terms shows at ~2e-5 of the loss: on
# this test's batch a float64 evaluation of the port's forward gives
# 6.179930, the JAX package's fp32 forward 6.179975 (+0.7e-5 of it) and the
# port's 6.179837 (-1.5e-5). The loss is held within 5e-5 of its value.
SDP_NLL_TOL = 5e-5
HOP = 16
AUDIO = dict(fft_size=128, win_length=128, hop_length=HOP, num_mels=20)


def train_args(use_sdp: bool, **kw):
    return tiny_vits_args(
        num_layers_text_encoder=1, num_layers_posterior_encoder=1, num_layers_flow=1,
        resblock_kernel_sizes_decoder=[3], resblock_dilation_sizes_decoder=[[1, 3]],
        periods_multi_period_discriminator=[2, 3], discriminator_width_mult=1 / 16,
        spec_segment_size=8, use_sdp=use_sdp,
        dropout_p_text_encoder=0.0, dropout_p_duration_predictor=0.0,  # no masks drawn
    ) | kw


def train_configs(use_sdp: bool, config_kw=None, **kw):
    """``(JAX VitsConfig, port VitsConfig)`` of the same fields."""
    jcfg = JaxVitsConfig(model_args=JaxVitsArgs(**train_args(use_sdp, **kw)), **(config_kw or {}))
    for k, v in AUDIO.items():
        setattr(jcfg.audio, k, v)
    return jcfg, VitsConfig.from_dict(jcfg.to_dict())


def train_pair(use_sdp: bool, config_kw=None, **kw):
    """The JAX model with its (generator, discriminator) params and the port
    model carrying the same weights."""
    jcfg, pcfg = train_configs(use_sdp, config_kw, **kw)
    jm = JaxVits(jcfg)
    gen_params, disc_params = fast_params(jm.init_params, jax.random.PRNGKey(0), seed=0,
                                          scale=WEIGHT_SCALE)
    port = Vits(pcfg)
    port.load_state_dict(vits_from_jax_params(gen_params))
    port.discriminator = port.discriminator.to_empty(device="cpu")
    port.load_discriminator_state_dict(vits_discriminator_from_jax_params(disc_params))
    return jm, gen_params, disc_params, port, pcfg


def train_batch(seed=0, B=3, T_x=12, T_y=40, C=65):
    """Ids, a linear spectrogram and a waveform of ragged lengths (numpy)."""
    rs = np.random.RandomState(seed)
    return dict(
        text_input=rs.randint(1, 48, (B, T_x)).astype(np.int32),
        text_lengths=np.array([T_x, T_x - 3, 5][:B], np.int32),
        spec=np.abs(rs.randn(B, T_y, C)).astype(np.float32),
        spec_lengths=np.array([T_y, T_y - 7, 17][:B], np.int32),
        waveform=(rs.randn(B, T_y * HOP, 1) * 0.1).astype(np.float32),
    )


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device).long() if k == "text_input"
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def recorded_jax_draws():
    """``jax.random.normal`` and ``uniform`` record their values, also from
    inside jitted programs (``jax.debug.callback``)."""
    draws = {"normal": [], "uniform": []}
    orig = {name: getattr(jax.random, name) for name in draws}

    def recording(name):
        def draw(*args, **kwargs):
            value = orig[name](*args, **kwargs)
            jax.debug.callback(lambda v: draws[name].append(np.asarray(v)), value)
            return value
        return draw

    for name in draws:
        setattr(jax.random, name, recording(name))
    try:
        yield draws
    finally:
        for name, fn in orig.items():
            setattr(jax.random, name, fn)


@contextlib.contextmanager
def replayed_draws(draws):
    """The port's ``modules.normal`` and ``helpers.uniform`` return the
    recorded draws of the asked shape, first in first out; all must be
    used."""
    queues = {k: list(v) for k, v in draws.items()}

    def take(kind, shape):
        for i, value in enumerate(queues[kind]):
            if tuple(value.shape) == tuple(shape):
                return torch.from_numpy(queues[kind].pop(i))
        raise AssertionError(f"no recorded {kind} draw of shape {tuple(shape)}")

    orig_normal, orig_uniform = modules.normal, helpers.uniform
    modules.normal = lambda shape, generator: take("normal", shape).to(generator.device)
    helpers.uniform = lambda shape, generator: take("uniform", shape).to(generator.device)
    try:
        yield
    finally:
        modules.normal, helpers.uniform = orig_normal, orig_uniform
    assert not any(queues.values()), f"draws left unused: {queues}"


def close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{what}: {err:.3g} > {tol} x {peak:.3g}"


def jax_forward(jm, gen_params, batch):
    """The JAX training forward op by op (not jitted: XLA's fusions sum the
    duration NLL's large terms in another order), its draws recorded."""
    with recorded_jax_draws() as draws:
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        keys = jax.random.split(jax.random.PRNGKey(3), 3)
        out = jm.module.apply(gen_params, b["text_input"], b["text_lengths"], b["spec"],
                              b["spec_lengths"], b["waveform"], train=True,
                              rngs=dict(zip(("noise", "segments", "dropout"), keys)))
        out = jax.tree.map(np.asarray, out)
        jax.effects_barrier()
    return out, draws


@pytest.fixture(scope="module", params=[True, False], ids=["sdp", "dp"])
def forward_pair(request):
    jm, gen_params, _, port, _ = train_pair(request.param)
    batch = train_batch()
    want, draws = jax_forward(jm, gen_params, batch)
    with replayed_draws(draws):
        got = port.module(*[torch_batch(batch)[k] for k in (
            "text_input", "text_lengths", "spec", "spec_lengths")], torch.Generator())
    return want, got, draws, request.param


def test_training_forward_matches_jax(forward_pair):
    want, got, draws, use_sdp = forward_pair
    # the posterior's noise, and the duration posterior's with the SDP
    assert len(draws["normal"]) == (2 if use_sdp else 1) and len(draws["uniform"]) == 1
    np.testing.assert_array_equal(got["alignments"].numpy(), want["alignments"])
    np.testing.assert_array_equal(got["slice_ids"].numpy(), want["slice_ids"])
    np.testing.assert_array_equal(got["durations"].numpy(), want["durations"])
    for k in ("m_p", "logs_p", "z", "z_p", "m_q", "logs_q", "model_outputs"):
        close(got[k], want[k], what=k)
    close(got["loss_duration"], want["loss_duration"], SDP_NLL_TOL if use_sdp else TOL,
          what="loss_duration")
    assert got["model_outputs"].shape == (3, 8 * HOP, 1)


def test_alignment_is_a_monotonic_path(forward_pair):
    got = forward_pair[1]
    attn = got["alignments"].transpose(1, 2)  # [B, T_x, T_y]
    x_len = torch.tensor([12, 9, 5])
    y_len = torch.tensor([40, 33, 17])
    for b in range(3):
        a = attn[b, : x_len[b], : y_len[b]]
        assert torch.all(a.sum(0) == 1)  # one token a frame
        tokens = a.argmax(0)
        assert tokens[0] == 0 and tokens[-1] == x_len[b] - 1
        assert torch.all(torch.diff(tokens) >= 0) and torch.all(torch.diff(tokens) <= 1)
        assert attn[b].sum() == y_len[b]  # nothing outside the mask


def test_f12_training_feeds_the_prior_means(monkeypatch):
    """F12: the duration predictor reads ``m_p`` in training (as the JAX
    package's training does), the text encoder's output at inference."""
    jm, gen_params, _, port, _ = train_pair(False)
    seen = []
    orig = type(port.module.duration_predictor).forward

    def spy(self, x, *args, **kwargs):
        seen.append(x)
        return orig(self, x, *args, **kwargs)

    monkeypatch.setattr(type(port.module.duration_predictor), "forward", spy)
    batch = torch_batch(train_batch())
    hidden, m_p, _, _ = port.module.text_encoder(batch["text_input"], batch["text_lengths"])
    port.module(batch["text_input"], batch["text_lengths"], batch["spec"],
                batch["spec_lengths"], torch.Generator().manual_seed(0))
    assert torch.equal(seen[-1], m_p) and not torch.equal(seen[-1], hidden)
    port.inference(batch["text_input"], batch["text_lengths"], max_frames=60)
    assert torch.equal(seen[-1], hidden)


# ---------------------------------------------------------------------------
# the step's entry point


def test_make_train_step_defaults_to_cuda():
    _, _, _, port, pcfg = train_pair(True)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.make_train_step(pcfg, torch.Generator())


def test_refuses_what_is_not_ported():
    """The YourTTS speaker-consistency loss raises. (Speakers and languages
    train: ``tests/test_torch_vits_train_speakers.py``.)"""
    _, _, _, port, pcfg = train_pair(True)
    port.args.use_speaker_encoder_as_loss = True
    with pytest.raises(NotImplementedError, match="17a"):
        port.make_train_step(pcfg, torch.Generator(), device="cpu")


def test_step_leaves_eval_mode_and_inference_unchanged():
    """A step updates the weights through the port's entry point on the CPU
    and leaves the model in eval mode, where inference draws no dropout."""
    _, _, _, port, pcfg = train_pair(True, dropout_p_text_encoder=0.1,
                                     dropout_p_duration_predictor=0.5)
    step, optimizers, state = port.make_train_step(pcfg, torch.Generator().manual_seed(0),
                                                   device="cpu")
    assert set(optimizers) == {"gen", "disc"} and state.step == 0
    before = [p.detach().clone() for p in state.params["gen"]]
    state, metrics = step(state, torch_batch(train_batch()))
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params["gen"]))
    assert not port.module.training
    ids = torch.from_numpy(train_batch()["text_input"]).long()
    lengths = torch.tensor([12, 9, 5])
    a = port.inference(ids, lengths, max_frames=60, generator=torch.Generator().manual_seed(1))
    b = port.inference(ids, lengths, max_frames=60, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["model_outputs"], b["model_outputs"])
    evaluate = port.make_eval_step(pcfg)
    m1, m2 = evaluate(state, torch_batch(train_batch())), evaluate(state,
                                                                  torch_batch(train_batch()))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)  # fixed draws


def test_bf16_autocast_step_is_finite_and_near_fp32():
    """``mixed_precision=True``: bf16 autocast over fp32 master weights (a
    named divergence from the JAX package's bf16 parameter copies,
    ``trainer/precision.py``), so it is held to the port's fp32 step on the
    same draws: every loss finite and within 5 % (+ 0.05) of fp32, and both
    groups' weights updated and finite."""
    runs = {}
    for mixed in (False, True):
        _, _, _, port, pcfg = train_pair(True, config_kw={"mixed_precision": mixed})
        step, _, state = port.make_train_step(pcfg, torch.Generator().manual_seed(0),
                                              device="cpu")
        before = {k: [p.detach().clone() for p in v] for k, v in state.params.items()}
        state, metrics = step(state, torch_batch(train_batch()))
        runs[mixed] = metrics
        for k in ("gen", "disc"):
            assert any(not torch.equal(a, b) for a, b in zip(before[k], state.params[k]))
            assert all(torch.isfinite(p).all() for p in state.params[k])
    for k, v in runs[True].items():
        assert torch.isfinite(v), k
        ref = runs[False][k]
        assert abs(float(v) - float(ref)) <= 0.05 * abs(float(ref)) + 0.05, (k, float(v),
                                                                               float(ref))


def test_train_state_groups_are_the_models_parameters():
    _, _, _, port, pcfg = train_pair(True)
    state = port_train.create_train_state(copy.deepcopy(port), pcfg)
    names = port_train.param_names(port)
    assert len(state.params["gen"]) == len(names["gen"])
    assert len(state.params["disc"]) == len(names["disc"]) and names["disc"][0].startswith(
        "disc_s.")
    assert all(p.requires_grad for v in state.params.values() for p in v)
