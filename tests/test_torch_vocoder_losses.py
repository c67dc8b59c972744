"""The port's vocoder training pieces against the JAX package's, on the
CPU: ``audio.torch_transforms``' ``stft_real_imag``, ``spectral_norm_log``,
``amp_to_db`` and ``db_to_amp``; the PQMF analysis (and analysis then
synthesis, as ``tests/test_vocoder.py::test_pqmf_reconstruction`` does for
the JAX bank); and every loss of ``vocoder/losses.py``: the STFT losses,
the (mel) spectrogram L1, feature matching, the generator's composite loss
with each switch and the discriminator's, mse and hinge.

Inputs come from numpy seeds. Tolerances: the STFT's real and imaginary
parts within 1e-5 of their peak (the same DFT basis and sums; fp32
rounding of ~1000-term sums), the PQMF bands within 1e-6, the losses within
1e-5 of each value.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vocoder_cases import AUDIO, STFT, SUBBAND_STFT, gan_configs

from tts_tpu.audio import jax_transforms as jt
from tts_tpu.vocoder import losses as jax_losses
from tts_tpu.vocoder.models.melgan_generator import PQMF as JaxPQMF
from tts_tpu_torch.audio import torch_transforms as tt
from tts_tpu_torch.vocoder import losses
from tts_tpu_torch.vocoder.layers import PQMF

LOSS_TOL = 1e-5  # of each value


def _wav(B=2, T=2048, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(T) / 22050
    return np.stack([0.5 * np.sin(2 * np.pi * rs.uniform(100, 900) * t) + 0.1 * rs.randn(T)
                     for _ in range(B)]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_value(got, want, what=""):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-6), (what, got, want)


@pytest.mark.parametrize("center,pad_wav,pad_mode", [(True, False, "reflect"),
                                                      (True, False, "constant"),
                                                      (False, True, "reflect"),
                                                      (False, False, "reflect")])
def test_stft_real_imag_matches_jax(center, pad_wav, pad_mode):
    """Both parts, batched and 1-D, each padding the JAX function offers."""
    y = _wav()
    for x in (y, y[0]):
        want = jt.stft_real_imag(jnp.asarray(x), 256, 64, 200, center=center, pad_mode=pad_mode,
                                 pad_wav=pad_wav)
        got = tt.stft_real_imag(_t(x), 256, 64, 200, center=center, pad_mode=pad_mode,
                                pad_wav=pad_wav)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_log_and_decibel_transforms_match_jax():
    """``spectral_norm_log`` (with its clamp), ``amp_to_db`` in both bases
    and gains, and ``db_to_amp`` its inverse."""
    x = np.abs(np.random.RandomState(1).randn(4, 50)).astype(np.float32) * 3
    x[0, :5] = 0.0  # below every clamp
    np.testing.assert_allclose(tt.spectral_norm_log(_t(x)).numpy(),
                               np.asarray(jt.spectral_norm_log(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    for gain, base in ((1.0, 10.0), (20.0, 10.0), (1.0, np.e)):
        db = tt.amp_to_db(_t(x), gain, base)
        np.testing.assert_allclose(db.numpy(), np.asarray(jt.amp_to_db(jnp.asarray(x), gain, base)),
                                   rtol=1e-6, atol=1e-5)
        back = tt.db_to_amp(db, gain, base)
        np.testing.assert_allclose(back.numpy(), np.asarray(jt.db_to_amp(
            jnp.asarray(db.numpy()), gain, base)), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(back.numpy()[1:], x[1:], rtol=1e-4)


def test_spec_to_mel_keeps_its_values():
    """``spec_to_mel`` now goes through ``spectral_norm_log``: the same as
    the JAX ``spec_to_mel``."""
    spec = np.abs(np.random.RandomState(2).randn(2, 129, 20)).astype(np.float32)
    want = jt.spec_to_mel(jnp.asarray(spec), 256, 16, 22050)
    got = tt.spec_to_mel(_t(spec), 256, 16, 22050)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [4, 2])
def test_pqmf_analysis_matches_jax(N):
    """The bands of a batch, ``[B, T / N, N]``, within 1e-6."""
    x = _wav(T=4096)[..., None]
    want = np.asarray(JaxPQMF(N=N).analysis(jnp.asarray(x)))
    got = PQMF(N=N).analysis(_t(x)).numpy()
    assert got.shape == want.shape == (2, 4096 // N, N)
    assert np.abs(got - want).max() <= 1e-6


def test_pqmf_analysis_then_synthesis_reconstructs():
    """Analysis then synthesis gives the signal back after the bank's group
    delay, within the JAX test's 0.07 (the reference bank's phase quirk),
    and the port's round trip equals the JAX one."""
    pqmf = PQMF(N=4)
    t = np.linspace(0, 1, 4096, endpoint=False)
    x = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    sub = pqmf.analysis(_t(x)[None, :, None])
    assert sub.shape == (1, 1024, 4)
    x_rec = pqmf.synthesis(sub)[0, :, 0].numpy()
    jp = JaxPQMF(N=4)
    want = np.asarray(jp.synthesis(jp.analysis(jnp.asarray(x)[None, :, None])))[0, :, 0]
    assert np.abs(x_rec - want).max() <= 1e-6
    corr = np.correlate(x_rec, x, mode="full")
    shift = int(np.argmax(corr)) - (len(x) - 1)
    assert 0 <= shift <= 80, shift
    a = x_rec[shift: shift + len(x) - shift]
    b = x[: len(a)]
    assert np.abs(a[100:-100] - b[100:-100]).max() < 0.07


def test_stft_losses_match_jax():
    """``stft_loss`` at each resolution and ``multiscale_stft_loss``."""
    y, y_hat = _wav(seed=0), _wav(seed=1)
    for n, h, w in zip(STFT["n_ffts"], STFT["hop_lengths"], STFT["win_lengths"]):
        for g, j in zip(losses.stft_loss(_t(y_hat), _t(y), n, h, w),
                        jax_losses.stft_loss(jnp.asarray(y_hat), jnp.asarray(y), n, h, w)):
            close_value(g, j, f"stft {n}")
    got = losses.multiscale_stft_loss(_t(y_hat), _t(y), STFT["n_ffts"], STFT["hop_lengths"],
                                      STFT["win_lengths"])
    want = jax_losses.multiscale_stft_loss(jnp.asarray(y_hat), jnp.asarray(y), STFT["n_ffts"],
                                           STFT["hop_lengths"], STFT["win_lengths"])
    for g, j in zip(got, want):
        close_value(g, j, "multiscale")


@pytest.mark.parametrize("use_mel", [True, False])
def test_l1_spec_loss_matches_jax(use_mel):
    y, y_hat = _wav(seed=0), _wav(seed=1)
    kw = dict(sample_rate=22050, n_fft=256, hop=64, win=256, n_mels=16, use_mel=use_mel)
    close_value(losses.l1_spec_loss(_t(y_hat), _t(y), **kw),
                jax_losses.l1_spec_loss(jnp.asarray(y_hat), jnp.asarray(y), **kw))


def _maps(seed, shapes):
    rs = np.random.RandomState(seed)
    return [[rs.randn(*s).astype(np.float32) for s in group] for group in shapes]


SHAPES = [[(2, 30, 8), (2, 10, 16), (2, 10, 1)], [(2, 12, 3, 4), (2, 4, 3, 1)]]


def test_feature_matching_loss_matches_jax():
    """The mean L1 over every map; the real maps carry no gradient."""
    ff, fr = _maps(0, SHAPES), _maps(1, SHAPES)
    want = jax_losses.feature_matching_loss([[jnp.asarray(a) for a in g] for g in ff],
                                            [[jnp.asarray(a) for a in g] for g in fr])
    tf = [[_t(a).requires_grad_() for a in g] for g in ff]
    tr = [[_t(a).requires_grad_() for a in g] for g in fr]
    got = losses.feature_matching_loss(tf, tr)
    close_value(got, want)
    got.backward()
    assert all(a.grad is None for g in tr for a in g)
    assert all(a.grad is not None for g in tf for a in g)


def _scores(seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, 7 + i).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("family,switches", [
    ("hifigan", {}),
    ("melgan", {}),
    ("multiband_melgan", {}),
    ("hifigan", dict(use_hinge_gan_loss=True, hinge_G_loss_weight=0.7, use_stft_loss=True,
                     stft_loss_weight=0.3, stft_loss_params=STFT)),
])
def test_generator_loss_matches_jax(family, switches):
    """Every term the config switches on, each weight, the sums."""
    jcfg, pcfg = gan_configs(family, **switches)
    jl, pl = jax_losses.GeneratorLossConfig(jcfg), losses.GeneratorLossConfig(pcfg)
    assert vars(jl) == vars(pl)
    y, y_hat = _wav(seed=0)[..., None], _wav(seed=1)[..., None]
    sub = np.stack([_wav(T=512, seed=10 + i) for i in range(4)], -1)  # [2, 512, 4] bands
    sub_hat = np.stack([_wav(T=512, seed=20 + i) for i in range(4)], -1)
    sf, ff, fr = _scores(3), _maps(4, SHAPES), _maps(5, SHAPES)
    want = jax_losses.generator_loss(
        jl, y_hat=jnp.asarray(y_hat), y=jnp.asarray(y), scores_fake=[jnp.asarray(s) for s in sf],
        feats_fake=[[jnp.asarray(a) for a in g] for g in ff],
        feats_real=[[jnp.asarray(a) for a in g] for g in fr],
        y_hat_sub=jnp.asarray(sub_hat), y_sub=jnp.asarray(sub))
    got = losses.generator_loss(
        pl, y_hat=_t(y_hat), y=_t(y), scores_fake=[_t(s) for s in sf],
        feats_fake=[[_t(a) for a in g] for g in ff], feats_real=[[_t(a) for a in g] for g in fr],
        y_hat_sub=_t(sub_hat), y_sub=_t(sub))
    assert set(got) == set(want)
    for k in want:
        close_value(got[k], want[k], k)


@pytest.mark.parametrize("use_mse,use_hinge", [(True, False), (False, True), (True, True)])
def test_discriminator_loss_matches_jax(use_mse, use_hinge):
    sf, sr = _scores(6), _scores(7)
    want = jax_losses.discriminator_loss([jnp.asarray(s) for s in sf],
                                         [jnp.asarray(s) for s in sr], use_mse, use_hinge)
    got = losses.discriminator_loss([_t(s) for s in sf], [_t(s) for s in sr], use_mse, use_hinge)
    assert set(got) == set(want)
    for k in want:
        close_value(got[k], want[k], k)


def test_audio_fields_read_from_a_dict_too():
    """``GeneratorLossConfig`` reads the audio fields from a config object
    or a plain dict, as the JAX one does."""
    _, pcfg = gan_configs("hifigan")
    from types import SimpleNamespace

    as_dict = SimpleNamespace(**{k: getattr(pcfg, k) for k in ("use_l1_spec_loss",)},
                              audio=dict(AUDIO))
    assert losses.GeneratorLossConfig(as_dict).l1_spec_params == \
        losses.GeneratorLossConfig(pcfg).l1_spec_params


def test_subband_params_of_the_tiny_case_fit_its_bands():
    """The sub-band STFT's largest window fits a 512-sample band (the tiny
    multi-band case's), so the reflect padding of both packages applies."""
    assert max(SUBBAND_STFT["n_ffts"]) // 2 < 512
