"""The building blocks of VITS training in the port against the JAX
package's, on the CPU at small widths: ``segment`` and ``rand_segments``
(the JAX package's uniforms replayed through
``tts_tpu_torch.ops.helpers.uniform``), ``average_over_durations``, the
period and scale discriminators and ``VitsDiscriminator`` on lengths that
no period divides, the duration flows' forward direction with their
log-determinants, the stochastic duration predictor's NLL (its noise
replayed through ``modules.normal``), the four losses, and dropout.

Values agree within 1e-5 of each output's peak (fp32; the two packages sum
in other orders); integer outputs (segment starts) are equal. The JAX
parameters are N(0, 0.1²) (``helpers.fast_params``) carried over by the
port's converters. Dropout is checked in the port alone: its masks come
from the given generator, so JAX's cannot be replayed; in eval mode the
layers compute exactly what they do without it.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_params
from test_torch_vits_model import record_jax_normals, replay_normals

from tts_tpu.models.vits import model as jax_model
from tts_tpu.models.vits import modules as jax_modules
from tts_tpu.ops import helpers as jax_helpers
from tts_tpu.vocoder.models import hifigan_discriminator as jax_disc
from tts_tpu_torch.layers import common
from tts_tpu_torch.layers.transformer import RelativePositionTransformer
from tts_tpu_torch.models.vits import model as port_model
from tts_tpu_torch.models.vits import modules
from tts_tpu_torch.ops import helpers
from tts_tpu_torch.utils.convert import flax_to_state_dict
from tts_tpu_torch.vocoder.models import hifigan_discriminator as port_disc

TOL = 1e-5  # of each output's peak


def close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{what}: {err:.3g} > {tol} x {peak:.3g}"


def port_module(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module


@pytest.fixture
def replay_uniforms(monkeypatch):
    """Swap the port's ``uniform`` for a queue of recorded draws."""
    queue = []

    def replay(shape, generator):
        value = torch.from_numpy(queue.pop(0))
        assert tuple(value.shape) == tuple(shape)
        return value

    monkeypatch.setattr(helpers, "uniform", replay)
    return queue


# ---------------------------------------------------------------------------
# segments


def test_segment_clamps_like_dynamic_slice():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 20, 3).astype(np.float32)
    starts = np.array([0, 5, 17, 30], np.int32)  # the last two run past the end
    want = jax_helpers.segment(jnp.asarray(x), jnp.asarray(starts), 6)
    close(helpers.segment(torch.from_numpy(x), torch.from_numpy(starts), 6), want)
    short = x[:, :4]
    want = jax_helpers.segment(jnp.asarray(short), jnp.asarray(starts * 0), 6, pad_short=True)
    close(helpers.segment(torch.from_numpy(short), torch.zeros(4, dtype=torch.int32), 6,
                          pad_short=True), want)


@pytest.mark.parametrize("kw", [dict(), dict(let_short_samples=True),
                                dict(let_short_samples=True, pad_short=True)],
                         ids=["plain", "let_short", "pad_short"])
def test_rand_segments_on_replayed_uniforms(replay_uniforms, kw):
    rs = np.random.RandomState(1)
    x = rs.randn(5, 24, 4).astype(np.float32)
    lengths = np.array([24, 10, 8, 3, 17], np.int32)
    if not kw:
        lengths = np.maximum(lengths, 8)
    orig = jax.random.uniform
    drawn = []

    def recording(*args, **kwargs):
        drawn.append(np.array(orig(*args, **kwargs)))
        return drawn[-1]

    jax.random.uniform = recording
    try:
        want, want_ids = jax_helpers.rand_segments(jax.random.PRNGKey(3), jnp.asarray(x),
                                                   jnp.asarray(lengths), 8, **kw)
    finally:
        jax.random.uniform = orig
    replay_uniforms.extend(drawn)
    got, ids = helpers.rand_segments(torch.Generator(), torch.from_numpy(x),
                                     torch.from_numpy(lengths), 8, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    close(got, want)
    assert not replay_uniforms


def test_uniform_draws_from_the_given_generator():
    a = helpers.uniform((5,), torch.Generator().manual_seed(4))
    b = helpers.uniform((5,), torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.dtype == torch.float32 and (0 <= a).all() and (a < 1).all()


def test_average_over_durations():
    rs = np.random.RandomState(2)
    values = rs.randn(3, 30, 2).astype(np.float32)
    values[values < -0.5] = 0.0  # unset frames
    durs = np.array([[3, 0, 7, 5, 20], [1, 1, 1, 1, 1], [10, 10, 10, 5, 0]], np.int32)
    want = jax_helpers.average_over_durations(jnp.asarray(values), jnp.asarray(durs))
    close(helpers.average_over_durations(torch.from_numpy(values), torch.from_numpy(durs)),
          want)


# ---------------------------------------------------------------------------
# discriminators


def waveform(B, T, seed):
    return (np.random.RandomState(seed).randn(B, T, 1) * 0.3).astype(np.float32)


@pytest.mark.parametrize("period", [2, 3, 5])
def test_period_discriminator_odd_length(period):
    x = waveform(2, 301, period)  # no period divides it: reflection padding
    jm = jax_disc.DiscriminatorP(period, width_mult=1 / 16)
    params = fast_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), scale=0.1)
    want_score, want_feats = jm.apply(params, jnp.asarray(x))
    pm = port_module(port_disc.DiscriminatorP(period, width_mult=1 / 16), params)
    score, feats = pm(torch.from_numpy(x))
    close(score, want_score, what="score")
    assert len(feats) == len(want_feats) == 6
    for i, (f, w) in enumerate(zip(feats, want_feats)):
        close(f, w, what=f"feature {i}")  # time-major [B, T', period, C]


@pytest.mark.parametrize("width_mult", [1 / 16, 1 / 8], ids=["w16", "w8"])
def test_scale_discriminator_groups(width_mult):
    """The group counts under ``width_mult`` (gcd of groups, c_in, c_out)."""
    x = waveform(2, 517, 9)
    jm = jax_disc.DiscriminatorS(width_mult=width_mult)
    params = fast_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), scale=0.1)
    pm = port_module(port_disc.DiscriminatorS(width_mult=width_mult), params)
    want_score, want_feats = jm.apply(params, jnp.asarray(x))
    score, feats = pm(torch.from_numpy(x))
    close(score, want_score, what="score")
    for i, (f, w) in enumerate(zip(feats, want_feats)):
        close(f, w, what=f"feature {i}")
    assert [c.groups for c in pm.convs] == [
        np.gcd(np.gcd(g, c.in_channels), c.out_channels)
        for (_, _, _, g, _), c in zip(port_disc.DiscriminatorS.SPEC, pm.convs)]


def test_vits_discriminator_both_and_one_input():
    fake, real = waveform(2, 203, 1), waveform(2, 203, 2)
    jm = jax_modules.VitsDiscriminator(periods=(2, 3, 5, 7, 11), width_mult=1 / 16)
    params = fast_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(fake), jnp.asarray(real),
                         scale=0.1)
    pm = port_module(modules.VitsDiscriminator((2, 3, 5, 7, 11), width_mult=1 / 16), params)
    want = jm.apply(params, jnp.asarray(fake), jnp.asarray(real))
    got = pm(torch.from_numpy(fake), torch.from_numpy(real))
    for part in (0, 2):  # scores
        for g, w in zip(got[part], want[part]):
            close(g, w, what="score")
    for part in (1, 3):  # features
        for gs, ws in zip(got[part], want[part]):
            for g, w in zip(gs, ws):
                close(g, w, what="feature")
    alone = pm(torch.from_numpy(fake))
    assert alone[2] == [] and alone[3] == []
    for g, w in zip(alone[0], want[0]):
        close(g, w, what="score alone")


# ---------------------------------------------------------------------------
# the duration flows, forward


def flow_inputs(B=2, T=11, seed=3):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, T, 2) * 2).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 7:] = 0
    g = rs.randn(B, T, 16).astype(np.float32)
    return x, mask, g


def test_elementwise_affine_forward_logdet():
    x, mask, _ = flow_inputs()
    jm = jax_modules.ElementwiseAffine(2)
    params = {"params": {"translation": jnp.asarray([0.3, -0.2]),
                         "log_scale": jnp.asarray([0.1, -0.4])}}
    want_y, want_ld = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    pm = port_module(modules.ElementwiseAffine(2), params)
    y, ld = pm(torch.from_numpy(x), torch.from_numpy(mask), reverse=False)
    close(y, want_y, what="y")
    close(ld, want_ld, what="logdet")
    back = pm(y, torch.from_numpy(mask))  # the inverse undoes it
    close(back, x * mask, tol=1e-6, what="inverse")


def test_conv_flow_forward_logdet():
    x, mask, g = flow_inputs()
    jm = jax_modules.ConvFlow(2, 16, 3, num_layers=3)
    params = fast_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                         jnp.asarray(g), scale=0.3)
    want_y, want_ld = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    pm = port_module(modules.ConvFlow(2, 16, 3, 3), params)
    y, ld = pm(torch.from_numpy(x), torch.from_numpy(mask), g=torch.from_numpy(g),
               reverse=False)
    close(y, want_y, what="y")
    close(ld, want_ld, what="logdet")
    back = pm(y, torch.from_numpy(mask), g=torch.from_numpy(g))
    close(back, x * mask, tol=1e-5, what="inverse")


def test_stochastic_duration_predictor_nll():
    """The training direction on replayed noise (one ``[B, T, 2]`` draw)."""
    rs = np.random.RandomState(4)
    B, T, C = 3, 9, 16
    x = rs.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    dr = (rs.randint(1, 6, (B, T, 1)) * mask).astype(np.float32)
    jm = jax_modules.StochasticDurationPredictor(C, 24, 3, 0.0, num_flows=4)
    params = fast_params(lambda key: jm.init({"params": key, "noise": key}, jnp.asarray(x),
                                             jnp.asarray(mask), dr=jnp.asarray(dr)),
                         jax.random.PRNGKey(0), scale=0.1)
    with jax.disable_jit(), record_jax_normals() as draws:
        want = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), dr=jnp.asarray(dr),
                        rngs={"noise": jax.random.PRNGKey(5)})
    pm = port_module(modules.StochasticDurationPredictor(C, 24, 3, num_flows=4), params)
    with replay_normals(draws):
        got = pm.nll(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(dr),
                     torch.Generator())
    close(got, want, what="nll")


# ---------------------------------------------------------------------------
# losses


def test_losses():
    rs = np.random.RandomState(6)
    z_p, logs_q, m_p, logs_p = (rs.randn(2, 10, 4).astype(np.float32) * 0.5 for _ in range(4))
    z_mask = np.ones((2, 10, 1), np.float32)
    z_mask[1, 6:] = 0
    t = [torch.from_numpy(a) for a in (z_p, logs_q, m_p, logs_p, z_mask)]
    close(port_model.kl_loss(*t),
          jax_model.kl_loss(*map(jnp.asarray, (z_p, logs_q, m_p, logs_p)),
                            z_mask=jnp.asarray(z_mask)))
    real = [[rs.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fake = [[rs.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    as_t = lambda fs: [[torch.from_numpy(f) for f in g] for g in fs]  # noqa: E731
    as_j = lambda fs: [[jnp.asarray(f) for f in g] for g in fs]  # noqa: E731
    close(port_model.feature_loss(as_t(real), as_t(fake)),
          jax_model.feature_loss(as_j(real), as_j(fake)))
    s_real = [rs.randn(2, 7).astype(np.float32) for _ in range(3)]
    s_fake = [rs.randn(2, 7).astype(np.float32) for _ in range(3)]
    close(port_model.generator_adv_loss([torch.from_numpy(s) for s in s_fake]),
          jax_model.generator_adv_loss([jnp.asarray(s) for s in s_fake]))
    got = port_model.discriminator_adv_loss([torch.from_numpy(s) for s in s_real],
                                            [torch.from_numpy(s) for s in s_fake])
    want = jax_model.discriminator_adv_loss([jnp.asarray(s) for s in s_real],
                                            [jnp.asarray(s) for s in s_fake])
    close(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        close(g, w)


def test_feature_loss_does_not_reach_the_real_features():
    real = [[torch.randn(2, 4, requires_grad=True)]]
    fake = [[torch.randn(2, 4, requires_grad=True)]]
    port_model.feature_loss(real, fake).backward()
    assert real[0][0].grad is None and fake[0][0].grad is not None


# ---------------------------------------------------------------------------
# dropout


def test_dropout_draws_from_the_given_generator():
    """Train mode: the mask is ``bernoulli(1 - p)`` from the generator given
    by ``use_dropout_generator``, kept values scaled by 1 / (1 - p); the same
    seed gives the same mask, and torch's global generator is not touched.
    Eval mode: the input comes back unchanged."""
    layer = common.Dropout(0.25)
    x = torch.randn(4, 50)
    assert common.Dropout(0.0)(x) is x  # rate 0: nothing drawn in either mode
    layer.eval()
    assert layer(x) is x
    layer.train()
    with pytest.raises(RuntimeError):
        layer(x)  # training mode without a generator
    common.use_dropout_generator(layer, torch.Generator().manual_seed(9))
    state = torch.get_rng_state()
    y = layer(x)
    assert torch.equal(torch.get_rng_state(), state)
    keep = common.bernoulli(x.shape, 0.75, torch.Generator().manual_seed(9))
    assert torch.equal(y, torch.where(keep, x / 0.75, torch.zeros(())))
    assert 0 < int((y == 0).sum()) < x.numel()
    common.use_dropout_generator(layer, torch.Generator().manual_seed(9))
    assert torch.equal(layer(x), y)


def test_dropout_in_the_layers_acts_in_training_mode_only():
    """A relative-position transformer with dropout: in eval mode it equals
    the same weights built without dropout, bit for bit; in training mode
    its output depends on the generator's seed."""
    torch.manual_seed(0)
    with_p = RelativePositionTransformer(16, 32, 2, 2, 3, 4, dropout_p=0.3)
    without = RelativePositionTransformer(16, 32, 2, 2, 3, 4)
    without.load_state_dict(with_p.state_dict())
    x, mask = torch.randn(2, 9, 16), torch.ones(2, 9, 1)
    assert torch.equal(with_p.eval()(x, mask), without.eval()(x, mask))
    with_p.train()
    outs = []
    for seed in (1, 1, 2):
        common.use_dropout_generator(with_p, torch.Generator().manual_seed(seed))
        outs.append(with_p(x, mask))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], without(x, mask))
