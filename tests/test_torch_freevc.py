"""The port's FreeVC (``tts_tpu_torch.vc.models.freevc``) and its converters
(``utils.convert.freevc_from_jax_params``, ``load_reference_freevc``,
``reference_freevc_state``) against the JAX package's, on the CPU.

The same weights go into both packages: flax parameters with every leaf
drawn (:func:`drawn_freevc_params`: kernels N(0, 1/fan_in), the coupling
flows' ``post`` a tenth of that, biases N(0, 0.1²)) at small widths
(content 12 wide, latent 8, hidden 16, speaker 16, spectrogram 21 bins,
HiFiGAN from 32 channels ×4 ×4, as ``tests/test_convert_freevc.py``), carried
into the port by ``freevc_from_jax_params``. Waveforms agree within 1e-5.

The prior's noise cannot be shared by key (a ``torch.Generator`` cannot
replay ``jax.random``): :func:`jax_draw` takes the JAX draw out of a
separate ``apply`` under the key the JAX ``voice_conversion`` uses
(``PRNGKey(0)``), and the port gets it as ``noise`` or through
``tts_tpu_torch.models.vits.modules.normal``. ``test_jax_draw_is_the_draw_of_
voice_conversion`` checks that the JAX ``voice_conversion`` with its own key
equals the JAX submodules composed by hand on that draw.

Kept as the JAX package has it: F42, the default config decodes at 16 kHz
what it labels 24 kHz (``test_f42_default_rates_play_fast``); the raise of
``use_spk=True`` without an external encoder.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_wavlm import TINY, drawn_wavlm_params

from tts_tpu.utils.convert import convert_freevc as jax_convert_freevc
from tts_tpu.vc.configs import FreeVCConfig as JaxFreeVCConfig
from tts_tpu.vc.models import freevc as jax_freevc
from tts_tpu.vc.modules import wavlm as jax_wavlm
from tts_tpu_torch.models.vits import modules as vits_modules
from tts_tpu_torch.utils.convert import (
    freevc_from_jax_params,
    load_reference_freevc,
    reference_freevc_state,
    wavlm_from_jax_params,
)
from tts_tpu_torch.vc.configs import FreeVCConfig
from tts_tpu_torch.vc.models import freevc, setup_model
from tts_tpu_torch.vc.modules.wavlm import WavLM, WavLMConfig

WAVE_TOL = 1e-5
SMALL = dict(ssl_dim=12, inter_channels=8, hidden_channels=16, gin_channels=16, spec_channels=21,
             resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]],
             upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32)


def small_config(cls=FreeVCConfig, **kw):
    config = cls()
    for k, v in (SMALL | kw).items():
        setattr(config.model_args, k, v)
    return config


def drawn_freevc_params(config, seed: int = 0):
    """Numpy flax params of the JAX ``FreeVCModule`` for ``config`` (traced
    through ``init_params``, never run), every leaf drawn as the module
    docstring says."""
    model = jax_freevc.FreeVC(config)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        z = rs.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "kernel":
            scale = 0.1 if keys[1] == "flow" and keys[-2] == "post" else 1.0
            return scale * z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.1 * z

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


@pytest.fixture(scope="module")
def models():
    """The JAX module and params, and the port's ``FreeVC`` on the CPU with
    the same weights."""
    jax_config = small_config(JaxFreeVCConfig)
    params = drawn_freevc_params(jax_config)
    port = freevc.FreeVC(small_config())
    port.load_state_dict(freevc_from_jax_params(params))
    return jax_freevc.FreeVCModule(args=jax_config.model_args), params, port


def jax_draw(module, params, shape, key=None) -> np.ndarray:
    """The standard normal draw of the JAX ``voice_conversion`` under
    ``key`` (``PRNGKey(0)``, its default), from an ``apply`` of its own."""
    draw = module.apply(params, method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                        rngs={"noise": jax.random.PRNGKey(0) if key is None else key})
    return np.asarray(draw)


def jax_composed(module, params, c, lengths, g, eps) -> np.ndarray:
    """The JAX submodules composed by hand: ``enc_p``, the prior sample on
    ``eps``, ``flow`` in reverse, ``dec``."""
    def fn(m, c, lengths, g, eps):
        m_p, logs_p, x_mask = m.enc_p(c, lengths)
        z_p = m_p + jnp.exp(logs_p) * eps * 0.5
        z = m.flow(z_p * x_mask, x_mask, g=g, reverse=True)
        return m.dec(z * x_mask, g=g)

    return np.asarray(module.apply(params, c, lengths, g, eps, method=fn))


@contextlib.contextmanager
def replayed(table):
    """``vits_modules.normal`` returns ``table[shape]`` (numpy), on the
    generator's device."""
    real = vits_modules.normal
    vits_modules.normal = lambda shape, generator: torch.tensor(
        table[tuple(shape)], device=generator.device)
    try:
        yield
    finally:
        vits_modules.normal = real


def test_content_encoder_matches_jax(models):
    module, params, port = models
    rs = np.random.RandomState(0)
    c = rs.randn(2, 13, 12).astype(np.float32)
    lengths = np.array([13, 9])
    want = module.apply(params, c, lengths, method=lambda m, c, l: m.enc_p(c, l))
    with torch.no_grad():
        got = port.module.enc_p(torch.from_numpy(c), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert float(got[0][1, 9:].abs().max()) == 0.0  # masked past its length


def test_speaker_encoder_matches_jax(models):
    module, params, port = models
    mel = np.random.RandomState(1).randn(2, 9, 80).astype(np.float32)
    want = np.asarray(module.apply(params, mel, method=lambda m, x: m.enc_spk(x)))
    with torch.no_grad():
        got = port.module.enc_spk(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("T", [100, 128, 129, 300])
def test_embed_utterance_partials_matches_jax(models, T):
    """One window up to 128 frames; beyond, windows of 128 every 64 frames
    plus the last 128, averaged."""
    module, params, port = models
    mel = np.random.RandomState(T).randn(1, T, 80).astype(np.float32)
    want = jax_freevc.embed_utterance_partials(
        lambda w: module.apply(params, w, method=lambda m, x: m.enc_spk(x)), jnp.asarray(mel))
    calls = []

    def apply(windows):
        calls.append(tuple(windows.shape))
        return port.module.enc_spk(windows)

    with torch.no_grad():
        got = freevc.embed_utterance_partials(apply, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    n = 1 if T <= 128 else len(range(0, T - 128, 64)) + 1
    assert calls == [(n, min(T, 128), 80)]


def test_jax_draw_is_the_draw_of_voice_conversion(models):
    """The JAX ``voice_conversion`` under its own key equals the JAX
    submodules composed on :func:`jax_draw`'s draw, so that draw is the one
    the port must be given."""
    module, params, _ = models
    rs = np.random.RandomState(2)
    c, g = rs.randn(1, 13, 12).astype(np.float32), rs.randn(1, 16).astype(np.float32)
    lengths = np.array([13])
    eps = jax_draw(module, params, (1, 13, 8))
    want = jax_freevc.FreeVC(small_config(JaxFreeVCConfig)).voice_conversion(
        params, c, lengths, g)
    np.testing.assert_allclose(jax_composed(module, params, c, lengths, g, eps),
                               np.asarray(want), atol=1e-6, rtol=0)


def test_voice_conversion_matches_jax_on_one_draw(models):
    module, params, port = models
    rs = np.random.RandomState(3)
    c, g = rs.randn(2, 13, 12).astype(np.float32), rs.randn(2, 16).astype(np.float32)
    lengths = np.array([13, 10])
    eps = rs.randn(2, 13, 8).astype(np.float32)
    want = jax_composed(module, params, c, lengths, g, eps)
    got = port.voice_conversion(c, lengths, g, noise=torch.from_numpy(eps)).numpy()
    assert got.shape == want.shape == (2, 13 * 16, 1)
    np.testing.assert_allclose(got, want, atol=WAVE_TOL, rtol=0)
    # without noise the draw comes from the generator, seeded 0 by default
    again = port.voice_conversion(c, lengths, g).numpy()
    np.testing.assert_array_equal(again, port.voice_conversion(c, lengths, g).numpy())
    assert not np.allclose(again, got)


def write_wav(path, seconds: float, sr: int, seed: int) -> str:
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 180 + 40 * seed
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.5 * f0 * t)
    x = x + 0.03 * rs.randn(len(t))
    scipy.io.wavfile.write(path, sr, (x * 32767).astype(np.int16))
    return str(path)


def tiny_wavlm_pair(ssl_dim: int = 32):
    """The tiny WavLM of ``tests/test_freevc.py`` in both packages, on the
    same drawn weights: ``(jax extractor, port WavLM)``."""
    jax_cfg = jax_wavlm.WavLMConfig(**TINY)
    wl_params = drawn_wavlm_params(jax_cfg, seed=5)
    wl = jax_wavlm.WavLM(jax_cfg)
    port_wl = WavLM(WavLMConfig(**TINY))
    port_wl.load_state_dict(wavlm_from_jax_params(wl_params), strict=True)
    return jax.jit(lambda w: wl.apply(wl_params, w)), port_wl.eval()


def test_voice_conversion_from_files_matches_jax(tmp_path):
    """Both packages' ``voice_conversion_from_files`` on the same two files
    (the source at 16 kHz, the target at 22.05 kHz, resampled on load, 2.5 s
    so that its speaker embedding averages windows) and weights, the tiny
    WavLM as content extractor, the port replaying the JAX draw."""
    jax_config = small_config(JaxFreeVCConfig, ssl_dim=32)
    params = drawn_freevc_params(jax_config, seed=1)
    jax_model = jax_freevc.FreeVC(jax_config)
    jax_model.set_params(params)
    port = setup_model(small_config(ssl_dim=32))
    port.load_state_dict(freevc_from_jax_params(params))
    jax_model.content_extractor, port.content_extractor = tiny_wavlm_pair()
    src = write_wav(tmp_path / "src.wav", 1.0, 16000, seed=0)
    tgt = write_wav(tmp_path / "tgt.wav", 2.5, 22050, seed=1)

    want = jax_model.voice_conversion_from_files(src, [tgt])
    frames = len(want) // 16
    eps = jax_draw(jax_model.module, params, (1, frames, 8))
    with replayed({(1, frames, 8): eps}):
        got = port.voice_conversion_from_files(src, [tgt])
    assert got.dtype == np.float32 and got.shape == want.shape == (frames * 16,)
    np.testing.assert_allclose(got, want, atol=WAVE_TOL, rtol=0)


def test_reference_layout_round_trips(models):
    """``reference_freevc_state`` writes the reference names (coupling
    layers at ``flow.flows.{0,2,4,6}``, ``dec.cond``, 1x1 convolutions,
    ``enc_spk.lstm.*_l<n>``), and ``load_reference_freevc`` reads them back
    into the state ``freevc_from_jax_params`` gives, exactly; the JAX
    converter reads the same file into the original params."""
    _, params, port = models
    state = port.module.state_dict()
    reference = reference_freevc_state(state)
    assert {"flow.flows.6.enc.cond_layer.weight", "dec.cond.weight", "enc_spk.lstm.weight_ih_l2",
            "enc_p.enc.in_layers.15.weight", "enc_q.enc.res_skip_layers.0.weight"} <= set(reference)
    assert not any(k.startswith("flow.flows.1.") for k in reference)
    assert reference["enc_p.pre.weight"].ndim == 3 and reference["enc_spk.linear.weight"].ndim == 2
    loaded = load_reference_freevc({k: torch.from_numpy(v) for k, v in reference.items()})
    assert set(loaded) == set(state)
    for k, v in freevc_from_jax_params(params).items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
    got = jax.tree_util.tree_leaves_with_path(jax_convert_freevc(dict(reference)))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, leaf in got:
        np.testing.assert_allclose(leaf, want[path], rtol=1e-6, atol=1e-7, err_msg=str(path))
    assert len(got) == len(want)


def test_checkpoint_loads_strictly_from_either_layout(models, tmp_path):
    """``FreeVC.load_checkpoint`` takes a reference-layout ``model.pth``
    (under ``"model"``) or the port's own state_dict; ``enc_q`` is there for
    the strict load, though inference never runs it."""
    _, _, port = models
    state = port.module.state_dict()
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_freevc_state(state).items()}}, tmp_path / "model.pth")
    torch.save(state, tmp_path / "model_torch.pt")
    for name in ("model.pth", "model_torch.pt"):
        other = freevc.FreeVC(small_config())
        other.load_checkpoint(other.config, str(tmp_path / name), device="cpu")
        for k, v in other.module.state_dict().items():
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    assert any(k.startswith("enc_q.") for k in state)


def test_use_spk_raises_without_an_external_encoder():
    """With ``use_spk=True`` neither package builds ``enc_spk``, and both
    raise unless an external speaker encoder is attached."""
    jax_model = jax_freevc.FreeVC(small_config(JaxFreeVCConfig, use_spk=True))
    port = freevc.FreeVC(small_config(use_spk=True))
    assert not hasattr(port.module, "enc_spk")
    wav16k = np.zeros(16000, np.float32)
    with pytest.raises(RuntimeError, match="use_spk=True") as jax_raise:
        jax_model._embed_target_speaker(wav16k)
    with pytest.raises(RuntimeError, match="use_spk=True") as port_raise:
        port.embed_target_speaker(wav16k)
    assert str(port_raise.value) == str(jax_raise.value)

    class External:
        def embed_utterance(self, wav):
            return np.full(16, len(wav) / 16000, np.float32)

    port.speaker_encoder = External()
    np.testing.assert_array_equal(port.embed_target_speaker(wav16k).numpy(), np.ones((1, 16)))


def test_f42_default_rates_play_fast():
    """F42 (kept): WavLM's strides make 50 content frames a second at 16
    kHz, and the default ``upsample_rates`` [10, 8, 2, 2] decode 320 samples
    a frame, 16 000 a second, labelled ``output_sample_rate`` 24 000: the
    default model's output lasts two thirds of its source, in both
    packages."""
    config, jax_config = FreeVCConfig(), JaxFreeVCConfig()
    for cfg in (config, jax_config):
        a = cfg.model_args
        a.ssl_dim, a.inter_channels, a.hidden_channels, a.gin_channels = 32, 8, 16, 16
        a.upsample_initial_channel, a.resblock_kernel_sizes = 32, [3]
        a.resblock_dilation_sizes = [[1, 3, 5]]
    assert config.model_args.upsample_rates == [10, 8, 2, 2]
    assert config.audio.output_sample_rate == 24000 and config.audio.input_sample_rate == 16000
    strides = int(np.prod([s for _, _, s in jax_wavlm._CONV_LAYERS]))
    assert strides == int(np.prod(config.model_args.upsample_rates)) == 320
    params = drawn_freevc_params(jax_config, seed=2)
    port = freevc.FreeVC(config)
    port.load_state_dict(freevc_from_jax_params(params))
    frames = 50  # one second of source at 16 kHz
    c = np.random.RandomState(4).randn(1, frames, 32).astype(np.float32)
    g = np.random.RandomState(5).randn(1, 16).astype(np.float32)
    out = port.voice_conversion(c, [frames], g).numpy().reshape(-1)
    want = jax_freevc.FreeVC(jax_config).voice_conversion(params, c, np.array([frames]), g)
    assert len(out) == np.asarray(want).size == frames * 320
    assert len(out) / config.audio.output_sample_rate == pytest.approx(2 / 3)
