"""The port's acoustic-model losses (``tts_tpu_torch.layers.losses``) and
the alignment network (``tts_tpu_torch.layers.aligner``) against the JAX
package's, on the CPU.

Inputs are drawn from numpy seeds; padded batches of unequal lengths. Each
loss agrees within 1e-5 of its value and its gradients (``jax.grad``
against ``torch.autograd``) within 1e-5 of each gradient's peak.

The forward-sum loss is ``F.ctc_loss(zero_infinity=True)`` in the port and
a ``lax.scan`` over the CTC lattice in the JAX package: they agree on every
sample that can be aligned. A sample with fewer frames than tokens cannot:
torch's ``zero_infinity`` gives it 0 (the reference's ``CTCLoss`` too),
the JAX lattice's finite -1e9 gives it ~1e9 / tokens
(``test_forward_sum_unalignable_sample``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import drawn_params

from tts_tpu.layers import aligner as jax_aligner
from tts_tpu.layers import losses as JL
from tts_tpu_torch.layers import losses as PL
from tts_tpu_torch.layers.aligner import AlignmentNetwork
from tts_tpu_torch.utils.convert import flax_to_state_dict

TOL = 1e-5  # of the value, and of each gradient's peak


def frames(seed, B=3, T=24, C=16, lengths=(24, 17, 11)):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, C).astype(np.float32), rs.randn(B, T, C).astype(np.float32),
            np.asarray(lengths, np.int32))


def both(jax_fn, port_fn, *arrays, grad_args=(0,)):
    """The value and gradients w.r.t. ``grad_args`` of each package's loss."""
    jargs = [jnp.asarray(a) for a in arrays]
    jval, jgrads = jax.value_and_grad(lambda *g: jax_fn(*[
        g[grad_args.index(i)] if i in grad_args else a for i, a in enumerate(jargs)]),
        argnums=tuple(range(len(grad_args))))(*[jargs[i] for i in grad_args])
    targs = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_args:
        targs[i].requires_grad_(True)
    pval = port_fn(*targs)
    pgrads = torch.autograd.grad(pval, [targs[i] for i in grad_args])
    return (float(jval), [np.asarray(g) for g in jgrads]), (float(pval.detach()),
                                                             [g.numpy() for g in pgrads])


def assert_close(jax_out, port_out, what, tol=TOL):
    (jv, jg), (pv, pg) = jax_out, port_out
    assert abs(pv - jv) <= tol * max(abs(jv), 1e-3), (what, pv, jv)
    for i, (a, b) in enumerate(zip(pg, jg)):
        err = float(np.abs(a - b).max())
        assert err <= tol * max(float(np.abs(b).max()), 1e-12), (what, i, err)


@pytest.mark.parametrize("seq_len_norm", [False, True])
@pytest.mark.parametrize("name", ["l1_loss_masked", "mse_loss_masked"])
def test_masked_l1_and_mse(name, seq_len_norm):
    y_hat, y, lens = frames(0)
    out = both(lambda a, b, n: getattr(JL, name)(a, b, n, seq_len_norm=seq_len_norm),
               lambda a, b, n: getattr(PL, name)(a, b, n, seq_len_norm=seq_len_norm),
               y_hat, y, lens, grad_args=(0, 1))
    assert_close(*out, name)


@pytest.mark.parametrize("delta", [1.0, 0.3])
def test_huber(delta):
    y_hat, y, lens = frames(1, C=1)
    out = both(lambda a, b, n: JL.huber_loss(a, b, n, delta=delta),
               lambda a, b, n: PL.huber_loss(a, b, n, delta=delta), y_hat, y, lens,
               grad_args=(0, 1))
    assert_close(*out, "huber")


def test_bce_masked():
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 20).astype(np.float32) * 3
    targets = (rs.rand(3, 20) > 0.7).astype(np.float32)
    lens = np.asarray([20, 13, 5], np.int32)
    out = both(lambda a, t, n: JL.bce_loss_masked(a, t, n, pos_weight=5.0),
               lambda a, t, n: PL.bce_loss_masked(a, t, n, pos_weight=5.0), logits, targets,
               lens)
    assert_close(*out, "bce")


@pytest.mark.parametrize("seed", [3, 4])
def test_ssim(seed):
    """SSIM's value and its gradients w.r.t. both spectrograms; the min-max
    normalisation's ties share their gradient alike in both packages."""
    y_hat, y, lens = frames(seed, T=32, lengths=(32, 21, 14))
    y_hat = 0.3 * y + 0.7 * y_hat
    out = both(JL.ssim_loss, PL.ssim_loss, y_hat, y, lens, grad_args=(0, 1))
    assert_close(*out, "ssim")
    assert 0.0 < out[1][0] < 1.0


def test_differential_spectral_loss():
    y_hat, y, lens = frames(5)
    out = both(JL.differential_spectral_loss, PL.differential_spectral_loss, y_hat, y, lens,
               grad_args=(0,))
    assert_close(*out, "differential")


def test_binary_alignment_loss():
    rs = np.random.RandomState(6)
    soft = rs.rand(2, 10, 30).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    hard = np.zeros_like(soft)
    for b in range(2):
        hard[b, np.sort(rs.randint(0, 10, 30)), np.arange(30)] = 1.0
    out = both(JL.binary_alignment_loss, PL.binary_alignment_loss, hard, soft, grad_args=(1,))
    assert_close(*out, "binary")


def alignable_logits(seed, B=3, T_de=40, T_en=12):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T_de, T_en).astype(np.float32) * 2,
            np.asarray([12, 9, 5], np.int32)[:B], np.asarray([40, 31, 20], np.int32)[:B])


@pytest.mark.parametrize("blank", [-1.0, 0.5])
@pytest.mark.parametrize("seed", [7, 8])
def test_forward_sum_loss_matches_the_jax_scan(seed, blank):
    """``F.ctc_loss`` against the JAX lattice: the loss and the gradient
    w.r.t. the aligner's log-probabilities (through the blank column, the
    masked keys and the log-softmax)."""
    logp, in_lens, out_lens = alignable_logits(seed)
    out = both(lambda a, i, o: JL.forward_sum_loss(a, i, o, blank_logprob=blank),
               lambda a, i, o: PL.forward_sum_loss(a, i, o, blank_logprob=blank),
               logp, in_lens, out_lens)
    assert_close(*out, "forward_sum")
    grad = out[1][1][0]
    assert np.all(grad[1, 31:] == 0) and np.all(grad[2, :, 5:] == 0)  # padding gets none


def test_forward_sum_unalignable_sample():
    """A sample with fewer frames (4) than tokens (9): torch's
    ``zero_infinity`` counts it as 0, the JAX lattice as ~1e9 / 9; the
    alignable samples agree."""
    logp, _, _ = alignable_logits(9, B=2)
    in_lens, out_lens = np.asarray([12, 9], np.int32), np.asarray([40, 4], np.int32)
    port = float(PL.forward_sum_loss(torch.from_numpy(logp), torch.from_numpy(in_lens),
                                     torch.from_numpy(out_lens)))
    jax_val = float(JL.forward_sum_loss(jnp.asarray(logp), jnp.asarray(in_lens),
                                        jnp.asarray(out_lens)))
    alone = float(JL.forward_sum_loss(jnp.asarray(logp[:1]), jnp.asarray(in_lens[:1]),
                                      jnp.asarray(out_lens[:1])))
    assert jax_val > 1e7
    assert abs(port - alone / 2) <= TOL * abs(alone)


@pytest.fixture(scope="module")
def aligner_pair():
    jm = jax_aligner.AlignmentNetwork(in_query_channels=16, in_key_channels=24,
                                      attn_channels=16, temperature=0.05)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 10, 16)),
                          jnp.zeros((1, 6, 24)), scale=0.3)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = AlignmentNetwork(16, 24, 16, 0.05)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, port


@pytest.mark.parametrize("prior,key_mask", [(False, False), (True, False), (True, True)])
def test_aligner_matches_jax(aligner_pair, prior, key_mask):
    """The soft attention and its log-probabilities, with the frame mask, an
    attention prior and a key mask, and the gradients of a loss of both
    w.r.t. the queries and the keys."""
    jm, params, port = aligner_pair
    rs = np.random.RandomState(10)
    q = rs.randn(2, 20, 16).astype(np.float32)
    k = rs.randn(2, 8, 24).astype(np.float32)
    mask = (np.arange(20)[None] < np.asarray([[20], [14]])).astype(np.float32)
    pri = rs.rand(2, 20, 8).astype(np.float32) if prior else None
    kmask = (np.arange(8)[None] < np.asarray([[8], [5]])).astype(np.float32) if key_mask \
        else None

    def jax_loss(qq, kk):
        attn, logp = jm.apply(params, qq, kk, mask=jnp.asarray(mask),
                              attn_prior=None if pri is None else jnp.asarray(pri),
                              key_mask=None if kmask is None else jnp.asarray(kmask))
        return jnp.sum(attn * jnp.arange(8)) + jnp.sum(jnp.where(jnp.isfinite(logp), logp, 0)
                                                       * 1e-2), (attn, logp)

    (jv, (jattn, jlogp)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k))
    tq, tk = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(k).requires_grad_(True)
    attn, logp = port(tq, tk, mask=torch.from_numpy(mask),
                      attn_prior=None if pri is None else torch.from_numpy(pri),
                      key_mask=None if kmask is None else torch.from_numpy(kmask))
    pv = torch.sum(attn * torch.arange(8)) + torch.sum(
        torch.where(torch.isfinite(logp), logp, 0) * 1e-2)
    pgrads = torch.autograd.grad(pv, [tq, tk])
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(jattn), atol=TOL)
    finite = np.isfinite(np.asarray(jlogp))
    np.testing.assert_array_equal(np.isfinite(logp.detach().numpy()), finite)
    np.testing.assert_allclose(logp.detach().numpy()[finite], np.asarray(jlogp)[finite],
                               atol=TOL * float(np.abs(np.asarray(jlogp)[finite]).max()))
    for a, b in zip(pgrads, jgrads):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= \
            TOL * float(np.abs(np.asarray(b)).max())
