"""The layers under the port's VITS, each against its JAX counterpart on the
CPU at a small size, within 1e-5: ``sequence_mask`` and ``generate_path``
(``ops/helpers.py``), the relative-position transformer with ragged masks
(``layers/transformer.py``; lengths below, at and above the attention
window, so the relative-embedding table is sliced and padded), the WaveNet
stack with and without conditioning (``layers/wavenet.py``), the
deterministic duration predictor (``layers/common.py``) and the
rational-quadratic spline in both directions, with inputs in the tails
(``models/vits/transforms.py``; its log-determinant, which inference does
not use, within 1e-4). The JAX modules get their own random init;
their flax trees are carried into the port by ``flax_to_state_dict``.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.layers.common import DurationPredictor as JaxDurationPredictor
from tts_tpu.layers.transformer import RelativePositionTransformer as JaxTransformer
from tts_tpu.layers.wavenet import WN as JaxWN
from tts_tpu.models.vits.transforms import (
    piecewise_rational_quadratic_transform as jax_spline,
)
from tts_tpu.ops import generate_path as jax_generate_path
from tts_tpu.ops import sequence_mask as jax_sequence_mask
from tts_tpu_torch.layers.common import DurationPredictor
from tts_tpu_torch.layers.transformer import RelativePositionTransformer
from tts_tpu_torch.layers.wavenet import WN
from tts_tpu_torch.models.vits.transforms import piecewise_rational_quadratic_transform
from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
from tts_tpu_torch.utils.convert import flax_to_state_dict

ATOL = 1e-5


def _mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _load(port, params):
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return port


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=what)


def test_sequence_mask_matches_jax():
    lengths = np.array([0, 1, 7, 12, 12], np.int32)
    got = sequence_mask(torch.from_numpy(lengths), 12)
    want = jax_sequence_mask(jnp.asarray(lengths), 12)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_path_matches_jax():
    rs = np.random.RandomState(0)
    T_x, T_y = 9, 40
    dur = rs.randint(0, 6, (3, T_x)).astype(np.float32)
    x_len = np.array([9, 6, 1])
    dur = dur * _mask(x_len, T_x)[..., 0]
    y_len = np.minimum(dur.sum(1), T_y).astype(np.int32)
    mask = _mask(x_len, T_x) * _mask(y_len, T_y).transpose(0, 2, 1)
    got = generate_path(torch.from_numpy(dur), torch.from_numpy(mask))
    want = jax_generate_path(jnp.asarray(dur), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each valid frame belongs to exactly one token
    np.testing.assert_array_equal(got.numpy().sum(1)[0, : y_len[0]], 1.0)


@pytest.mark.parametrize("T,lengths", [(3, [3, 2]), (5, [5, 4]), (13, [13, 6])],
                         ids=["below_window", "at_window", "above_window"])
def test_rel_pos_transformer_matches_jax(T, lengths):
    cfg = dict(hidden_channels=16, out_channels=16, hidden_channels_ffn=32, num_heads=2,
               num_layers=2, kernel_size=3, rel_attn_window_size=4)
    rs = np.random.RandomState(T)
    x = rs.randn(2, T, 16).astype(np.float32)
    mask = _mask(lengths, T)
    jax_mod = JaxTransformer(**cfg)
    params = jax_mod.init(jax.random.PRNGKey(T), jnp.asarray(x), jnp.asarray(mask))
    want = jax_mod.apply(params, jnp.asarray(x), jnp.asarray(mask))
    port = _load(RelativePositionTransformer(16, 32, num_heads=2, num_layers=2, kernel_size=3,
                                             rel_attn_window_size=4), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("cond", [None, "global", "per_frame"])
def test_wavenet_matches_jax(cond):
    H, T, C_g = 16, 21, 8
    rs = np.random.RandomState(1)
    x = rs.randn(2, T, H).astype(np.float32)
    mask = _mask([T, 15], T)
    g = {None: None, "global": rs.randn(2, C_g), "per_frame": rs.randn(2, T, C_g)}[cond]
    g = None if g is None else g.astype(np.float32)
    jax_mod = JaxWN(hidden_channels=H, kernel_size=5, dilation_rate=2, num_layers=3,
                    c_in_channels=C_g if g is not None else 0)
    jg = None if g is None else jnp.asarray(g)
    params = jax_mod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask), g=jg)
    want = jax_mod.apply(params, jnp.asarray(x), jnp.asarray(mask), g=jg)
    port = _load(WN(H, 5, 2, 3, c_in_channels=C_g if g is not None else 0), params)
    tg = None if g is None else torch.from_numpy(g)
    _close(port(torch.from_numpy(x), torch.from_numpy(mask), g=tg), want)


def test_duration_predictor_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, 16).astype(np.float32)
    mask = _mask([11, 7], 11)
    jax_mod = JaxDurationPredictor(hidden_channels=24, kernel_size=3, dropout_p=0.5)
    params = jax_mod.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(mask))
    want = jax_mod.apply(params, jnp.asarray(x), jnp.asarray(mask))
    port = _load(DurationPredictor(16, 24, 3), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_matches_jax_inside_and_in_the_tails(inverse):
    rs = np.random.RandomState(5)
    shape, bins = (3, 40), 10
    x = rs.uniform(-7.0, 7.0, shape).astype(np.float32)
    x[0, :4] = [-5.0, 5.0, -7.5, 6.2]  # the interval's ends and both tails
    # unit-scale bin logits, as the JAX package's own spline test draws them
    uw = rs.randn(*shape, bins).astype(np.float32)
    uh = rs.randn(*shape, bins).astype(np.float32)
    ud = rs.randn(*shape, bins - 1).astype(np.float32)
    assert (np.abs(x) > 5).sum() > 10
    got, got_ld = piecewise_rational_quadratic_transform(
        *(torch.from_numpy(a) for a in (x, uw, uh, ud)), inverse=inverse)
    want, want_ld = jax_spline(*(jnp.asarray(a) for a in (x, uw, uh, ud)), inverse=inverse)
    _close(got, want, "outputs")
    # the log-determinant (training only) is a difference of logs that fp32
    # puts 1.5-2e-5 from its float64 value in both packages at these inputs,
    # so it is held at 1e-4
    np.testing.assert_allclose(got_ld.numpy(), np.asarray(want_ld), rtol=0, atol=1e-4)
    tails = np.abs(x) > 5
    np.testing.assert_array_equal(got.numpy()[tails], x[tails])
    # the two directions invert each other
    back, back_ld = piecewise_rational_quadratic_transform(
        got, *(torch.from_numpy(a) for a in (uw, uh, ud)), inverse=not inverse)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back_ld.numpy(), -got_ld.numpy(), rtol=0, atol=1e-4)
