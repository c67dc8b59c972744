"""The port's vocoder discriminators (``tts_tpu_torch.vocoder.models``)
against the JAX package's, on the CPU, at small widths: HiFiGAN's
multi-period, multi-scale and combined discriminators, MelGAN's single and
multi-scale ones, UnivNet's (the spectrogram discriminators at the
config's three resolutions, then the multi-period one),
ParallelWaveGAN's, and the random window discriminator with its window
offsets given (the JAX module's draws, replayed; F56).

The JAX parameters are drawn at unit gain (``torch_vocoder_cases.
fan_in_params``) and carried strictly by
``utils.convert.vocoder_discriminator_from_jax_params``; the same seeded
waveform (and mel) goes through both. Every score and feature map, in the
JAX layout, agrees within 1e-5 of its tensor's peak.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vocoder_cases import fan_in_params

from tts_tpu.vocoder.models import hifigan_discriminator as jax_hifigan
from tts_tpu.vocoder.models import melgan_discriminator as jax_melgan
from tts_tpu.vocoder.models import parallel_wavegan_generator as jax_pwgan
from tts_tpu.vocoder.models import random_window_discriminator as jax_rwd
from tts_tpu.vocoder.models import univnet_discriminator as jax_univnet
from tts_tpu_torch.utils.convert import vocoder_discriminator_from_jax_params
from tts_tpu_torch.vocoder.models import (
    hifigan_discriminator,
    melgan_discriminator,
    parallel_wavegan_generator,
    random_window_discriminator,
    setup_discriminator,
    univnet_discriminator,
)

TOL = 1e-5  # of each tensor's peak
T = 4096

# kind → (JAX class, port class, kwargs)
KINDS = {
    "hifigan_mpd": (jax_hifigan.MultiPeriodDiscriminator,
                    hifigan_discriminator.MultiPeriodDiscriminator,
                    dict(periods=(2, 3, 5), width_mult=1 / 32)),
    "hifigan_msd": (jax_hifigan.MultiScaleDiscriminator,
                    hifigan_discriminator.MultiScaleDiscriminator,
                    dict(n_scales=3, width_mult=1 / 32)),
    "hifigan": (jax_hifigan.HifiganDiscriminator, hifigan_discriminator.HifiganDiscriminator,
                dict(width_mult=1 / 64)),
    "melgan": (jax_melgan.MelganDiscriminator, melgan_discriminator.MelganDiscriminator,
               dict(base_channels=8, max_channels=64, downsample_factors=(4, 4))),
    "melgan_multiscale": (jax_melgan.MelganMultiscaleDiscriminator,
                          melgan_discriminator.MelganMultiscaleDiscriminator,
                          dict(base_channels=4, max_channels=32, downsample_factors=(4, 4))),
    "univnet": (jax_univnet.UnivnetDiscriminator, univnet_discriminator.UnivnetDiscriminator,
                {}),
    "parallel_wavegan": (jax_pwgan.ParallelWaveganDiscriminator,
                         parallel_wavegan_generator.ParallelWaveganDiscriminator,
                         dict(num_layers=5, conv_channels=8)),
}


def _wav(seed=0, B=2, n=T):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 22050
    return np.stack([0.5 * np.sin(2 * np.pi * rs.uniform(100, 400) * t) + 0.1 * rs.randn(n)
                     for _ in range(B)]).astype(np.float32)[..., None]


def _flat(out):
    """``(scores, feats)`` as lists of arrays (a single discriminator's
    score and maps become one-entry lists, as the GAN step takes them)."""
    scores, feats = out
    if not isinstance(scores, (list, tuple)):
        scores, feats = [scores], [feats]
    return [np.asarray(s) for s in scores], [[np.asarray(f) for f in fs] for fs in feats]


def close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    assert peak > 1e-3, (what, peak)
    err = float(np.abs(got - want).max())
    assert err <= TOL * peak, (what, err, peak)


@functools.lru_cache(maxsize=None)
def build(kind):
    jax_cls, port_cls, kw = KINDS[kind]
    jm = jax_cls(**kw)
    params = fan_in_params(jm.init, jax.random.PRNGKey(0), _wav(), seed=3)
    port = port_cls(**kw)
    port.load_state_dict(vocoder_discriminator_from_jax_params(params), strict=True)
    return jm, params, port.eval()


@pytest.mark.parametrize("kind", list(KINDS))
def test_scores_and_feature_maps_match_jax(kind):
    """Every score and feature map within 1e-5 of its peak; the same count
    of each."""
    jm, params, port = build(kind)
    x = _wav(seed=5)
    want_s, want_f = _flat(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got_s, got_f = _flat(port(torch.from_numpy(x)))
    assert len(got_s) == len(want_s) and [len(f) for f in got_f] == [len(f) for f in want_f]
    for i, (g, w) in enumerate(zip(got_s, want_s)):
        close(g, w, f"{kind} score {i}")
    for i, (gs, ws) in enumerate(zip(got_f, want_f)):
        for j, (g, w) in enumerate(zip(gs, ws)):
            close(g, w, f"{kind} map {i}.{j}")


def jax_offsets(jm, rng, T: int, frames):
    """The JAX module's window offsets under ``rng``: one ``split`` a
    window, the unconditional windows first (``random_window_discriminator
    .py:126-145``)."""
    uncond, cond = [], []
    for ws in jm.window_sizes:
        rng, sub = jax.random.split(rng)
        uncond.append(int(jax.random.randint(sub, (), 0, max(1, T - ws))))
    if frames is not None:
        for ws in jm.window_sizes:
            rng, sub = jax.random.split(rng)
            size = ws // jm.hop_length
            cond.append(int(jax.random.randint(sub, (), 0, max(1, frames - size))))
    return uncond, cond


RWD_T = 9000  # past the largest window (8192), and not a whole number of hops


@pytest.fixture(scope="module")
def rwd():
    """The module at its default windows and hop (256) with narrow
    channels, a 16-channel mel of ``RWD_T // 256`` frames."""
    kw = dict(cond_channels=16, uncond_disc_out_channels=(16, 32),
              cond_disc_out_channels=((16, 16, 32, 32), (16, 32, 32), (16, 32), (32,), (16, 32)))
    jm = jax_rwd.RandomWindowDiscriminator(**kw)
    c = np.random.RandomState(1).randn(2, RWD_T // 256, 16).astype(np.float32)
    params = fan_in_params(jm.init, jax.random.PRNGKey(0), _wav(n=RWD_T), c,
                           rng=jax.random.PRNGKey(1), seed=4)
    port = random_window_discriminator.RandomWindowDiscriminator(**kw)
    port.load_state_dict(vocoder_discriminator_from_jax_params(params), strict=True)
    return jm, params, port.eval(), c


@pytest.mark.parametrize("conditioned", [False, True])
def test_random_window_discriminator_matches_jax_on_given_offsets(rwd, conditioned):
    """F56: with the JAX module's own offsets given (its key chain replayed),
    the unconditional scores, and with the mel the conditional ones too,
    match; the JAX module returns no feature maps, nor does the port's."""
    jm, params, port, c = rwd
    x = _wav(seed=6, n=RWD_T)
    rng = jax.random.PRNGKey(9)
    cc = c if conditioned else None
    want, want_f = jm.apply(params, jnp.asarray(x), None if cc is None else jnp.asarray(cc),
                            rng=rng)
    offsets = jax_offsets(jm, rng, RWD_T, None if cc is None else cc.shape[1])
    with torch.no_grad():
        got, got_f = port(torch.from_numpy(x), None if cc is None else torch.from_numpy(cc),
                          offsets=offsets)
    assert want_f == [] and got_f == []
    assert len(got) == len(want) == (10 if conditioned else 5)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g.numpy(), np.asarray(w), f"window {i}")


def test_random_window_draws_from_the_generator(rwd):
    """The port draws the offsets from an explicit generator: the same seed
    gives the same scores, another seed other windows; without offsets or
    a generator it raises."""
    _, _, port, c = rwd
    x, cc = torch.from_numpy(_wav(seed=6, n=RWD_T)), torch.from_numpy(c)
    with torch.no_grad():
        a, _ = port(x, cc, generator=torch.Generator().manual_seed(3))
        b, _ = port(x, cc, generator=torch.Generator().manual_seed(3))
        o = port.draw_offsets(RWD_T, cc.shape[1], torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert o != port.draw_offsets(RWD_T, cc.shape[1], torch.Generator().manual_seed(3))
    assert all(0 <= s <= RWD_T - ws for s, ws in zip(o[0], port.window_sizes))
    with pytest.raises(ValueError, match="offsets"):
        port(x, cc)


def test_registry_names_every_jax_discriminator():
    """``setup_discriminator`` resolves every name the JAX registry holds, to
    the port's class of the same name."""
    from tts_tpu.vocoder.models import _DISCRIMINATORS

    for name, target in _DISCRIMINATORS.items():
        assert setup_discriminator(name).__name__ == target.split(":")[1]
    with pytest.raises(ModuleNotFoundError):
        setup_discriminator("nope")
