"""The port's ParallelWaveGAN, UnivNet, iSTFT, WaveGrad and WaveRNN generators
(``tts_tpu_torch.vocoder.models``) and their converters against the JAX
package's, on the CPU, at tiny widths.

Each JAX generator takes flax parameters drawn from a seed (every leaf,
biases and smoothing taps included: ``test_torch_glow_tts.drawn_params``),
carried into the port strictly by ``utils.convert.*_from_jax_params``; the
same seeded mel and the same noise (numpy draws handed to both packages) go
through both, within 1e-5. The reference layout written by
``utils.convert.reference_*_state`` reads back through
``load_reference_vocoder`` exactly, and the committed fidelity fixtures
(reference-layout state dicts with the reference code's outputs) replay
through the port's converters under ``test_fidelity_corpus``'s bounds: 0.5
dB log-mel distance for the waveforms, a logits RMSE of 5e-3 for WaveRNN.

Noise the two packages cannot share: ``jax.random`` cannot be replayed by a
``torch.Generator``, so the port's own default draws (a generator seeded 0
on the mel's device) differ from the JAX package's ``PRNGKey(0)`` ones.
Where a test compares whole samplers it reproduces the JAX key chain in
numpy arrays and hands them to the port: WaveGrad's ``split`` per step, and
WaveRNN's ``split`` per sample, then per draw (``jax.random.categorical`` is
``argmax(logits + gumbel(key))``).

ParallelWaveGAN's and UnivNet's ``inference`` are the port's (ROADMAP.md
F31: the JAX modules have none); they are held against the JAX ``__call__``
on the mel as the port pads it (ParallelWaveGAN: ``inference_padding`` edge
frames on each side; UnivNet: none).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fidelity_corpus import _load, _lsd_db
from test_torch_glow_tts import drawn_params

from tts_tpu.vocoder.models import istft_hifigan as jax_istft
from tts_tpu.vocoder.models import parallel_wavegan_generator as jax_pwgan
from tts_tpu.vocoder.models import univnet_generator as jax_univnet
from tts_tpu.vocoder.models import wavegrad as jax_wavegrad
from tts_tpu.vocoder.models import wavernn as jax_wavernn
from tts_tpu_torch.utils import convert
from tts_tpu_torch.vocoder import configs
from tts_tpu_torch.vocoder.models import istft_hifigan, parallel_wavegan_generator, \
    univnet_generator, wavegrad, wavernn
from tts_tpu_torch.vocoder.utils import make_generator_from_config

ATOL = 1e-5
MELS, FRAMES = 16, 12
# WaveGrad's weights at N(0, 0.13²) put |noise_hat| near 1 (at 0.1 its peak
# is ~0.2, at 0.2 ~12: the eight-conv UBlocks compound the scale)
WAVEGRAD_SCALE = 0.13
LOOP_STEPS = 20  # the reverse diffusion compared whole, over the test schedule's range

# kind → (JAX class, port class, widths, weight scale, carrier, reference writer)
KINDS = {
    "parallel_wavegan": (jax_pwgan.ParallelWaveganGenerator,
                         parallel_wavegan_generator.ParallelWaveganGenerator,
                         dict(num_res_blocks=6, stacks=3, res_channels=8, gate_channels=16,
                              skip_channels=8, aux_channels=MELS, upsample_factors=(4, 2)),
                         0.3, convert.parallel_wavegan_from_jax_params,
                         convert.reference_parallel_wavegan_state),
    "univnet": (jax_univnet.UnivnetGenerator, univnet_generator.UnivnetGenerator,
                dict(in_channels=4, hidden_channels=8, cond_channels=MELS,
                     upsample_factors=(2, 4), lvc_layers_each_block=3, kpnet_hidden_channels=8),
                0.15, convert.univnet_from_jax_params, convert.reference_univnet_state),
    "istft_hifigan": (jax_istft.IstftHifiganGenerator, istft_hifigan.IstftHifiganGenerator,
                      dict(in_channels=MELS, upsample_initial_channel=32, upsample_factors=(4,),
                           upsample_kernel_sizes=(8,), resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), istft_n_fft=16, istft_hop=4),
                      0.1, convert.flax_to_state_dict, None),
    "wavegrad": (jax_wavegrad.Wavegrad, wavegrad.Wavegrad,
                 dict(in_channels=MELS, y_conv_channels=8, x_conv_channels=24,
                      dblock_out_channels=(8, 12), ublock_out_channels=(24, 12, 8),
                      upsample_factors=(2, 2, 2), upsample_dilations=((1, 2, 1, 2),) * 3),
                 WAVEGRAD_SCALE, convert.wavegrad_from_jax_params,
                 convert.reference_wavegrad_state),
    "wavernn": (jax_wavernn.Wavernn, wavernn.Wavernn,
                dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8, num_res_blocks=2,
                     feat_dims=MELS, upsample_factors=(2, 2), norm_type="folded"),
                0.3, convert.wavernn_from_jax_params, convert.reference_wavernn_state),
    "wavernn_layer_norm": (jax_wavernn.Wavernn, wavernn.Wavernn,
                           dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8,
                                num_res_blocks=2, feat_dims=MELS, upsample_factors=(2, 2)),
                           0.3, convert.wavernn_from_jax_params, convert.reference_wavernn_state),
}


def _mel(seed=0, T=FRAMES):
    return np.random.RandomState(seed).randn(1, T, MELS).astype(np.float32)


def _noise(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _hop(kw):
    return int(np.prod(kw["upsample_factors"])) * kw.get("istft_hop", 1)


def _inputs(kind, kw, c):
    """The JAX call's arguments after the mel for ``kind``: the noise (the
    GANs), the noisy waveform and noise level (WaveGrad), the teacher-forcing
    samples (WaveRNN)."""
    T = c.shape[1]
    if kind == "parallel_wavegan":
        return (_noise((1, T * _hop(kw), 1)),)
    if kind == "univnet":
        return (_noise((1, T, kw["in_channels"])),)
    if kind == "wavegrad":
        return (_noise((1, T * _hop(kw), 1)), np.asarray([0.6], np.float32))
    if kind.startswith("wavernn"):
        return (np.tanh(_noise((1, (T - 4) * _hop(kw)))),)
    return ()


def jax_forward(kind, jm, params, c, *args):
    if kind == "wavegrad":
        return jm.apply(params, args[0], c, args[1])
    if kind.startswith("wavernn"):
        return jm.apply(params, args[0], c)
    if kind == "univnet":
        return jm.apply(params, c, x=args[0])
    return jm.apply(params, c, *args)


def port_forward(kind, port, c, *args):
    t = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        if kind == "wavegrad":
            return port(t[0], torch.from_numpy(c), t[1]).numpy()
        if kind.startswith("wavernn"):
            return port(t[0], torch.from_numpy(c)).numpy()
        return port(torch.from_numpy(c), *t).numpy()


@functools.lru_cache(maxsize=None)
def build_pair(kind):
    """The JAX generator of ``kind``, its drawn params and the port's
    generator carrying them (strict), built once."""
    jax_cls, port_cls, kw, scale, carry, _ = KINDS[kind]
    jm = jax_cls(**kw)
    c = _mel()
    args = _inputs(kind, kw, c)
    init_args = ((args[0], c) if kind.startswith("wavernn") else
                 (args[0], c, np.ones(1, np.float32)) if kind == "wavegrad" else (c, *args))
    params = drawn_params(jm.init, jax.random.PRNGKey(0), *init_args, seed=2, scale=scale)
    port = port_cls(**kw)
    port.load_state_dict(carry(params), strict=True)
    return kind, jm, params, port.eval()


@pytest.fixture(params=list(KINDS))
def pair(request):
    return build_pair(request.param)


def test_forward_matches_jax(pair):
    """The network on a seeded mel with given noise: the GANs' waveform,
    WaveGrad's predicted noise (one reverse step's network, against
    ``Wavegrad.apply``), WaveRNN's teacher-forced logits (both norms),
    within 1e-5, at a real level."""
    kind, jm, params, port = pair
    c = _mel(3)
    args = _inputs(kind, KINDS[kind][2], c)
    want = np.asarray(jax_forward(kind, jm, params, c, *args))
    got = port_forward(kind, port, c, *args)
    assert got.shape == want.shape
    assert np.abs(want).max() > (0.3 if kind == "wavegrad" else 0.05)
    if kind == "wavegrad":
        assert np.abs(want).max() < 3  # |noise_hat| about 1 at WAVEGRAD_SCALE
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("kind", ["parallel_wavegan", "univnet", "istft_hifigan"])
def test_inference_matches_jax(kind):
    """``inference``: ParallelWaveGAN pads the mel by ``inference_padding``
    (2) edge frames on each side, UnivNet and the iSTFT generator pad
    nothing (F31); the JAX side runs ``__call__`` on the mel so padded (the
    iSTFT generator its own ``inference``), on the same noise. Without
    noise, the port's default draws repeat from call to call."""
    _, jm, params, port = build_pair(kind)
    kw = KINDS[kind][2]
    c = _mel(4)
    pad = 2 if kind == "parallel_wavegan" else 0
    padded = np.concatenate([c[:, :1]] * pad + [c] + [c[:, -1:]] * pad, axis=1)
    args = _inputs(kind, kw, padded)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(c), *(
            [None, torch.from_numpy(args[0])] if args else [])).numpy()
        drawn = port.inference(torch.from_numpy(c)).numpy()
        again = port.inference(torch.from_numpy(c)).numpy()
    if kind == "istft_hifigan":
        want = np.asarray(jm.apply(params, jnp.asarray(c), method=jm.inference))
    else:
        want = np.asarray(jax_forward(kind, jm, params, padded, *args))
    assert got.shape == want.shape == (1, (FRAMES + 2 * pad) * _hop(kw), 1)
    assert np.abs(got - want).max() <= ATOL
    np.testing.assert_array_equal(drawn, again)


def test_jax_params_carry_over_strictly(pair):
    """Every JAX leaf lands on one port parameter of its shape, and the port
    has no other: ``load_state_dict(strict=True)`` holds both ways."""
    kind, jm, params, port = pair
    carried = KINDS[kind][4](params)
    state = port.state_dict()
    assert {k: tuple(v.shape) for k, v in carried.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    missing = dict(carried)
    missing.pop(sorted(missing)[0])
    with pytest.raises(RuntimeError, match="Missing key"):
        port.load_state_dict(missing, strict=True)


CONFIGS = {"parallel_wavegan": "ParallelWaveganConfig", "univnet": "UnivnetConfig",
           "wavegrad": "WavegradConfig", "wavernn": "WavernnConfig",
           "wavernn_layer_norm": "WavernnConfig", "istft_hifigan": "GANConfig"}


def _config(kind, kw):
    config = getattr(configs, CONFIGS[kind])()
    config.audio.num_mels = MELS
    if kind == "istft_hifigan":
        config.generator_model = "istft_hifigan_generator"
    field = {"wavegrad": "model_params", "wavernn": "model_args",
             "wavernn_layer_norm": "model_args"}.get(kind, "generator_model_params")
    setattr(config, field, {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()})
    return config


def test_reference_layout_round_trip(pair):
    """The port's weights written in the reference layout
    (``reference_*_state``; the GANs' under ``model_g.``) read back through
    ``load_reference_vocoder`` and the config's generator exactly. WaveRNN's
    layer norms and the iSTFT generator have no reference layout. UnivNet
    has three LVC layers a block, of which the JAX package's converter reads
    two (ROADMAP.md F34); the port's reads all."""
    kind, jm, params, port = pair
    writer = KINDS[kind][5]
    config = _config(kind, KINDS[kind][2])
    if kind == "istft_hifigan":
        with pytest.raises(NotImplementedError, match="no reference layout"):
            convert.load_reference_vocoder({}, config)
        return
    if kind == "wavernn_layer_norm":
        with pytest.raises(ValueError, match="layer norms"):
            writer(port.state_dict())
        return
    ref = writer(port.state_dict())
    assert all(k.startswith("model_g.") for k in ref) == (kind in ("parallel_wavegan",
                                                                    "univnet"))
    if kind == "univnet":  # F34: the JAX converter reads two LVC layers of the three
        from tts_tpu.utils.convert import convert_univnet_generator

        bare = {k[len("model_g."):]: v for k, v in ref.items()}
        assert sorted(n for n in convert_univnet_generator(bare, num_blocks=2)["params"]["lvc_0"]
                      if n.startswith("conv_")) == ["conv_0", "conv_1"]
        assert "lvc_0.conv_2.weight" in convert.load_reference_vocoder(ref, config)
    back = convert.load_reference_vocoder(ref, config)
    state = port.state_dict()
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k
    assert set(make_generator_from_config(config).state_dict()) == set(state)


FIDELITY = {
    "parallel_wavegan": ("ParallelWaveganConfig", 80, dict(
        num_res_blocks=6, stacks=3, res_channels=8, gate_channels=16, skip_channels=8,
        upsample_factors=[4, 4])),
    "univnet": ("UnivnetConfig", 20, dict(in_channels=8, hidden_channels=8,
                                          upsample_factors=[2, 2], lvc_layers_each_block=2,
                                          kpnet_hidden_channels=8)),
    "wavegrad": ("WavegradConfig", 20, dict(
        y_conv_channels=8, x_conv_channels=24, dblock_out_channels=[8, 12],
        ublock_out_channels=[24, 12, 8], upsample_factors=[2, 2, 2],
        upsample_dilations=[[1, 2, 1, 2]] * 3)),
    "wavernn": ("WavernnConfig", 20, dict(rnn_dims=16, fc_dims=16, compute_dims=8,
                                          res_out_dims=8, num_res_blocks=2,
                                          upsample_factors=[2, 2])),
}


@pytest.mark.parametrize("family", list(FIDELITY))
def test_fidelity_fixture_replays(family):
    """``<family>.npz`` through the config's generator and
    ``load_reference_vocoder``: under 0.5 dB log-mel distance (the
    waveforms, on the fixture's noise), WaveRNN's teacher-forced logits
    under an RMSE of 5e-3."""
    state, ins, outs, meta = _load(family)
    kind, mels, params = FIDELITY[family]
    config = getattr(configs, kind)()
    config.audio.num_mels = mels
    field = {"wavegrad": "model_params", "wavernn": "model_args"}.get(
        family, "generator_model_params")
    setattr(config, field, params)
    port = make_generator_from_config(config)
    port.load_state_dict(convert.load_reference_vocoder(state, config), strict=True)
    mel = torch.from_numpy(ins["mel"].transpose(0, 2, 1))
    with torch.no_grad():
        if family == "wavernn":
            logits = port(torch.from_numpy(ins["x"]), mel).numpy()[0]
            assert np.sqrt(np.mean((logits - outs["logits"][0]) ** 2)) < 5e-3
            return
        if family == "wavegrad":
            wav = port(torch.from_numpy(ins["x"].transpose(0, 2, 1)), mel,
                       torch.from_numpy(ins["noise_scale"]))
        else:
            wav = port(mel, torch.from_numpy(ins["noise"].transpose(0, 2, 1)))
    wav = wav.numpy()[0, :, 0]
    ref = outs["wav"][0, 0]
    assert len(wav) == len(ref)
    assert _lsd_db(ref, wav) < 0.5


# ---------------------------------------------------------------------------
# WaveGrad's schedule and reverse diffusion
# ---------------------------------------------------------------------------


def test_wavegrad_noise_schedule_matches_jax():
    """``compute_noise_schedule``: the port's float64 arrays equal the JAX
    package's float32 ones once cast, for the test and train schedules."""
    for steps, lo, hi in ((50, 1e-6, 1e-2), (1000, 1e-6, 1e-2), (6, 1e-4, 0.05)):
        ours = wavegrad.compute_noise_schedule(steps, lo, hi)
        theirs = jax_wavegrad.compute_noise_schedule(steps, lo, hi)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b))


def jax_wavegrad_draws(shape, steps, key):
    """The JAX ``wavegrad_inference`` key chain's draws, ``[steps + 1,
    *shape]``: ``y`` from the first ``split``, then one ``z`` a step."""
    r0, rng = jax.random.split(key)
    draws = [jax.random.normal(r0, shape)]
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(jax.random.normal(sub, shape))
    return np.stack([np.asarray(d) for d in draws])


def test_wavegrad_loop_matches_jax_before_the_clip(monkeypatch):
    """The whole reverse diffusion (``LOOP_STEPS`` steps over the test
    schedule's range; the card runs all 50 in ``chip_smoke.py``) against
    ``wavegrad_inference`` on the JAX key chain's draws, compared before the
    final clip to ±1 (which would hide differences): the JAX function's
    ``jnp.clip`` is replaced by the identity for this call."""
    kind, jm, params, port = build_pair("wavegrad")
    c = _mel(5)
    schedule = jax_wavegrad.compute_noise_schedule(LOOP_STEPS)
    key = jax.random.PRNGKey(7)
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.clip = lambda y, *a, **k: y
    monkeypatch.setattr(jax_wavegrad, "jnp", proxy)
    want = np.asarray(jax_wavegrad.wavegrad_inference(jm, params, jnp.asarray(c), key, schedule))
    monkeypatch.undo()
    noise = jax_wavegrad_draws(want.shape, LOOP_STEPS, key)
    got = wavegrad.wavegrad_inference(port, torch.from_numpy(c),
                                      wavegrad.compute_noise_schedule(LOOP_STEPS),
                                      noise=torch.from_numpy(noise), clip=False).numpy()
    assert got.shape == want.shape == (1, FRAMES * 8, 1)
    assert np.abs(want).max() > 1  # the clip would have cut it
    assert np.abs(got - want).max() <= ATOL
    clipped = wavegrad.wavegrad_inference(port, torch.from_numpy(c),
                                          wavegrad.compute_noise_schedule(LOOP_STEPS),
                                          noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(clipped, np.clip(got, -1, 1))


# ---------------------------------------------------------------------------
# WaveRNN's GRU, sampling modes, length and mu-law
# ---------------------------------------------------------------------------


def test_gru_step_matches_flax_gru_cell():
    """One step of flax's ``GRUCell`` (the ``n`` gate's hidden bias inside
    ``r * (W_hn h + b_hn)``, no hidden bias on ``r`` and ``z``) against
    ``nn.GRUCell`` carrying ``_pack_gru``'s weights, within 1e-6."""
    import flax.linen as nn

    cell = nn.GRUCell(8)
    rs = np.random.RandomState(0)
    x, h = rs.randn(3, 5).astype(np.float32), rs.randn(3, 8).astype(np.float32)
    params = drawn_params(cell.init, jax.random.PRNGKey(0), h, x, seed=4, scale=0.5)["params"]
    want, _ = cell.apply({"params": params}, h, x)
    port = torch.nn.GRUCell(5, 8)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in convert._pack_gru(params).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-6


def jax_wavernn_draws(mode, n_classes, T, B, key):
    """The JAX ``generate`` key chain's draws, as the port's ``noise``
    dict: per sample one ``split``, then for ``mold`` a second ``split``
    into the component's Gumbel noise and the logistic's uniform (scanned:
    the same bits as the chain run step by step)."""
    def step(rng, _):
        rng, sub = jax.random.split(rng)
        if mode == "mold":
            r1, r2 = jax.random.split(sub)
            return rng, {"gumbel": jax.random.gumbel(r1, (B, n_classes // 3)),
                         "uniform": jax.random.uniform(r2, (B,), minval=1e-5, maxval=1 - 1e-5)}
        if mode == "gauss":
            return rng, {"normal": jax.random.normal(sub, (B,))}
        return rng, {"gumbel": jax.random.gumbel(sub, (B, n_classes))}

    _, draws = jax.lax.scan(step, key, None, length=T)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("mode", ["mold", "gauss", 4])
def test_wavernn_generate_matches_jax(mode):
    """``generate`` in each output mode on the JAX key chain's draws
    (``PRNGKey(3)``), 32 samples of two rows, within 1e-5; the port's shapes
    of draws are the JAX chain's."""
    kw = dict(KINDS["wavernn"][2], mode=mode)
    jm = jax_wavernn.Wavernn(**kw)
    c = np.concatenate([_mel(6, T=12), _mel(7, T=12)])
    params = drawn_params(jm.init, jax.random.PRNGKey(0), np.zeros((2, 8), np.float32), c,
                          seed=3, scale=0.3)
    if mode == "gauss":  # a log deviation near -2: the fed-back samples stay bounded
        fc3 = params["params"]["fc3"]
        fc3["kernel"] = np.asarray(fc3["kernel"]) * np.asarray([1.0, 0.1], np.float32)
        fc3["bias"] = np.asarray([0.0, -2.0], np.float32)
    port = wavernn.Wavernn(**kw)
    port.load_state_dict(convert.wavernn_from_jax_params(params), strict=True)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.apply(params, jnp.asarray(c), key, method=jm.generate))
    noise = jax_wavernn_draws(mode, port.n_classes, want.shape[1], 2, key)
    assert {k: tuple(v.shape) for k, v in noise.items()} == port.noise_shapes(want.shape[1], 2)
    got = port.generate(torch.from_numpy(c), noise=noise).numpy()
    assert got.shape == want.shape == (2, 32)
    assert np.abs(want).std() > 0.05
    assert np.abs(got - want).max() <= ATOL


def test_wavernn_length_and_mulaw_as_they_stand():
    """Two suspected divergences from the reference, kept as the JAX
    package has them (ROADMAP.md F32, F33): ``generate`` on a mel of
    ``T`` frames returns ``(T - 2 pad) * hop`` samples, ``2 pad`` frames
    short (nothing pads the mel first); an integer ``mode`` with ``mulaw``
    returns the linear grid ``2 idx / (n - 1) - 1``, not mu-law decoded. The
    port's default draws repeat from call to call."""
    kw = dict(KINDS["wavernn"][2], mode=4, mulaw=True)
    jm = jax_wavernn.Wavernn(**kw)
    c = _mel(8, T=7)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), np.zeros((1, 8), np.float32), c,
                          seed=5, scale=0.3)
    port = wavernn.Wavernn(**kw)
    port.load_state_dict(convert.wavernn_from_jax_params(params), strict=True)
    want = np.asarray(jm.apply(params, jnp.asarray(c), jax.random.PRNGKey(0),
                               method=jm.generate))
    got = port.generate(torch.from_numpy(c)).numpy()
    for wav in (want, got):
        assert wav.shape == (1, (7 - 2 * 2) * 4)
        idx = (wav + 1) * (16 - 1) / 2
        np.testing.assert_allclose(idx, np.round(idx), atol=1e-4)  # on the linear grid
    np.testing.assert_array_equal(got, port.generate(torch.from_numpy(c)).numpy())
