"""The port's MelGAN vocoders (``tts_tpu_torch.vocoder.models.melgan_generator``),
its generator registry (``vocoder.models.setup_generator``,
``vocoder.utils.make_generator_from_config``) and vocoder configs against
the JAX package's, on the CPU.

The three MelGAN generators take flax parameters drawn from a seed (every
leaf, biases included), carried into the port by
``utils.convert.melgan_from_jax_params``, and match the JAX generators'
``inference`` (two edge frames of padding on each side; the multi-band one
then merges its four bands with the PQMF synthesis filter) within 1e-5. The
committed fidelity fixtures ``multiband_melgan.npz`` and ``hifigan.npz``
(reference-layout state dicts with the reference code's audio) replay
through the port's own converters (``load_reference_vocoder``) under
``test_fidelity_corpus``'s 0.5 dB log-mel distance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fidelity_corpus import _load, _lsd_db
from test_torch_glow_tts import drawn_params

from tts_tpu.vocoder import configs as jax_configs
from tts_tpu.vocoder.models import melgan_generator as jax_melgan
from tts_tpu.vocoder.utils import make_generator_from_config as jax_make_generator
from tts_tpu_torch.models import config_from_dict
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    load_reference_vocoder,
    melgan_from_jax_params,
    reference_melgan_state,
)
from tts_tpu_torch.vocoder import configs
from tts_tpu_torch.vocoder.models import melgan_generator, setup_generator
from tts_tpu_torch.vocoder.utils import make_generator_from_config

ATOL = 1e-5
GENERATORS = {
    "melgan": ("MelganGenerator", dict(upsample_factors=(4, 2), num_res_blocks=2)),
    "multiband": ("MultibandMelganGenerator", dict(upsample_factors=(3, 2), num_res_blocks=3)),
    "fullband": ("FullbandMelganGenerator", dict(upsample_factors=(2, 2))),
}


def _mel(seed=0, T=20, C=16):
    return np.random.RandomState(seed).randn(1, T, C).astype(np.float32)


@pytest.fixture(scope="module", params=list(GENERATORS))
def generator_pair(request):
    name, kw = GENERATORS[request.param]
    kw = dict(in_channels=16, base_channels=32) | kw
    jm = getattr(jax_melgan, name)(**kw)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(_mel()), seed=2,
                          scale=0.2)
    port = getattr(melgan_generator, name)(**kw)
    port.load_state_dict(melgan_from_jax_params(params), strict=True)
    return request.param, jm, params, port


def test_generator_inference_matches_jax(generator_pair):
    """``inference`` (edge padding, the network, the PQMF synthesis for the
    multi-band one) within 1e-5, on audio of a real level."""
    name, jm, params, port = generator_pair
    c = _mel(1)
    want = np.asarray(jm.apply(params, jnp.asarray(c), method=jm.inference))
    with torch.no_grad():
        got = port.inference(torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (1, (20 + 4) * int(np.prod(GENERATORS[name][1][
        "upsample_factors"])) * (4 if name == "multiband" else 1), 1)
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= ATOL


def test_generator_forward_and_reference_layout(generator_pair):
    """The network without padding (the multi-band one's four bands) within
    1e-5, and the reference ``Sequential`` layout written by
    ``reference_melgan_state`` read back by ``load_reference_vocoder``."""
    name, jm, params, port = generator_pair
    c = _mel(2)
    with torch.no_grad():
        got = port(torch.from_numpy(c)).numpy()
    assert np.abs(got - np.asarray(jm.apply(params, jnp.asarray(c)))).max() <= ATOL
    config = configs.MultibandMelganConfig()
    config.generator_model = {"melgan": "melgan_generator", "multiband":
                              "multiband_melgan_generator",
                              "fullband": "fullband_melgan_generator"}[name]
    config.generator_model_params = {
        "upsample_factors": list(GENERATORS[name][1]["upsample_factors"]),
        "num_res_blocks": port.res_0.num_res_blocks}
    ref = reference_melgan_state(port.state_dict())
    assert all(k.startswith("model_g.layers.") for k in ref)
    back = load_reference_vocoder(ref, config)
    state = port.state_dict()
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


def test_multiband_melgan_fidelity_replay():
    """``multiband_melgan.npz`` through ``load_reference_vocoder`` and the
    generator ``make_generator_from_config`` builds: under 0.5 dB."""
    state, ins, outs, meta = _load("multiband_melgan")
    config = configs.MultibandMelganConfig()
    config.audio.num_mels = 20
    config.generator_model_params = {"upsample_factors": [2, 2], "num_res_blocks":
                                     meta["num_res_blocks"], "base_channels": 32,
                                     "use_weight_norm": True}
    port = make_generator_from_config(config)
    assert port.inference_padding == meta["inference_padding"]
    port.load_state_dict(load_reference_vocoder(state, config), strict=True)
    with torch.no_grad():
        wav = port.inference(torch.from_numpy(ins["mel"].transpose(0, 2, 1))).numpy()
    ref = outs["wav"][0, 0]
    assert wav.shape[1] == len(ref)
    assert _lsd_db(ref, wav[0, :, 0]) < 0.5


def test_hifigan_fidelity_replay_through_the_registry():
    """``hifigan.npz`` through the registry path: a ``HifiganConfig`` (the
    zoo's ``generator_model_params``), ``make_generator_from_config`` and
    ``load_reference_vocoder`` (the generator under ``model_g.``, as a GAN
    checkpoint holds it): under 0.5 dB. ``inference`` pads 5 edge frames on
    each side, as the JAX generator's does."""
    state, ins, outs, meta = _load("hifigan")
    m = meta["module"]
    config = configs.HifiganConfig()
    config.audio.num_mels = m["in_channels"]
    config.generator_model_params = {k: m[k] for k in (
        "resblock_type", "resblock_dilation_sizes", "resblock_kernel_sizes",
        "upsample_kernel_sizes", "upsample_initial_channel", "upsample_factors")}
    port = make_generator_from_config(config)
    port.load_state_dict(load_reference_vocoder(
        {"model_g." + k: v for k, v in state.items()}, config), strict=True)
    mel = torch.from_numpy(ins["mel"].transpose(0, 2, 1))
    with torch.no_grad():
        wav = port(mel).numpy()
        padded = port.inference(mel).numpy()
    assert _lsd_db(outs["wav"][0, 0], wav[0, :, 0]) < 0.5
    assert padded.shape[1] == wav.shape[1] + 10 * 16


@pytest.mark.parametrize("name", ["parallel_wavegan_generator", "univnet_generator",
                                  "wavegrad", "wavernn"])
def test_unregistered_generator_raises(name):
    """Generators the port does not run yet raise ``NotImplementedError``
    naming their ROADMAP.md item, from the registry and from a config."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 16"):
        setup_generator(name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 16"):
        config_from_dict({"generator_model": name})


@pytest.mark.parametrize("kind", ["MultibandMelganConfig", "FullbandMelganConfig",
                                  "MelganConfig", "HifiganConfig"])
def test_config_and_generator_match_jax(kind):
    """The copied vocoder configs equal the JAX package's, the registry reads
    them back from a ``config.json`` dict (by ``model``, or by a legacy
    ``generator_model`` alone), and ``make_generator_from_config`` builds
    the generator the JAX one builds, extra fields (``use_weight_norm``)
    dropped: the same parameter shapes."""
    ours, theirs = getattr(configs, kind)(), getattr(jax_configs, kind)()
    assert ours.to_dict() == theirs.to_dict()
    assert type(config_from_dict(ours.to_dict())) is type(ours)
    legacy = {k: v for k, v in ours.to_dict().items() if k != "model"}
    assert type(config_from_dict(legacy)) is type(ours)
    for c in (ours, theirs):
        c.audio.num_mels = 24
        c.generator_model_params = dict(c.generator_model_params, use_weight_norm=True)
    jm = jax_make_generator(theirs)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 24)))
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    port = make_generator_from_config(ours)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
