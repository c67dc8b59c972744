"""The port's VITS model (``tts_tpu_torch.models.vits``) against the JAX
package's, on the CPU at a small size (hidden 32, 2 encoder layers, 2 flows
of 2 WN layers, a 2-stage HiFiGAN).

The JAX parameters are carried into the port by ``vits_from_jax_params``.
The weights are N(0, 0.1²) (``helpers.fast_params``): a scale that keeps the
activations of order one, as in a trained model. The stochastic paths run
at their default noise scales on the JAX package's own noise: its
``jax.random.normal`` draws are recorded during an un-jitted call and
replayed into the port through ``tts_tpu_torch.models.vits.modules.normal``,
the one function the port draws its noise with. Durations and ``y_lengths``
must be equal; values agree within 1e-5 (encoder, flows, durations) and the
waveform within 1e-4.

The fidelity replay loads the reference-layout state dict of
``tests/fixtures/fidelity/vits.npz`` through the port's own converter copy
and checks the golden waveform as ``tests/test_fidelity_corpus.py`` does
for the JAX package.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_params
from test_fidelity_corpus import _load, _lsd_db

from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu_torch.models.vits import Vits, VitsConfig, modules
from tts_tpu_torch.utils.convert import vits_from_jax_params

ATOL = 1e-5
WAV_ATOL = 1e-4
WEIGHT_SCALE = 0.1


def tiny_vits_args(**kw):
    """Small ``VitsArgs`` fields; ``kw`` adds or overrides."""
    return dict(
        num_chars=48,
        out_channels=65,
        hidden_channels=32,
        hidden_channels_ffn_text_encoder=64,
        num_layers_text_encoder=2,
        num_layers_posterior_encoder=2,
        num_layers_flow=2,
        upsample_rates_decoder=[4, 4],
        upsample_kernel_sizes_decoder=[8, 8],
        upsample_initial_channel_decoder=64,
        resblock_kernel_sizes_decoder=[3, 5],
        resblock_dilation_sizes_decoder=[[1, 3], [1, 3]],
    ) | kw


def tiny_jax_vits(seed=0, config_kw=None, **kw):
    """A tiny JAX ``Vits`` (``config_kw``: top-level ``VitsConfig`` fields) and
    its generator params (N(0, 0.1²) fill)."""
    model = JaxVits(JaxVitsConfig(model_args=JaxVitsArgs(**tiny_vits_args(**kw)),
                                  **(config_kw or {})))
    gen_params, _ = fast_params(model.init_params, jax.random.PRNGKey(0), seed=seed,
                                scale=WEIGHT_SCALE)
    return model, gen_params


def port_of(jax_model, gen_params) -> Vits:
    port = Vits(VitsConfig.from_dict(jax_model.config.to_dict()))
    port.load_state_dict(vits_from_jax_params(gen_params))
    return port


@contextlib.contextmanager
def record_jax_normals():
    """Record every ``jax.random.normal`` draw made eagerly inside."""
    draws = []
    orig = jax.random.normal

    def recording(*args, **kwargs):
        value = orig(*args, **kwargs)
        draws.append(np.array(value))
        return value

    jax.random.normal = recording
    try:
        yield draws
    finally:
        jax.random.normal = orig


@contextlib.contextmanager
def replay_normals(draws):
    """The port's noise draws return ``draws`` in order, each checked for
    shape; all must be used."""
    queue = list(draws)
    orig = modules.normal

    def replay(shape, generator):
        value = torch.from_numpy(queue.pop(0))
        assert tuple(value.shape) == tuple(shape), (tuple(value.shape), tuple(shape))
        return value.to(generator.device)

    modules.normal = replay
    try:
        yield
    finally:
        modules.normal = orig
    assert not queue, f"{len(queue)} recorded draws left unused"


def _text_batch(seed=0, B=2, T=16, vocab=48):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, vocab, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 5][:B], np.int32)
    return x, lengths


def _close(got, want, atol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    jm, params = tiny_jax_vits()
    return jm, params, port_of(jm, params)


def test_weights_carry_over_strictly(pair):
    """``vits_from_jax_params`` gives exactly the port module's keys, with
    each leaf in the port's layout."""
    jm, params, port = pair
    state = vits_from_jax_params(params)
    assert set(state) == set(port.module.state_dict())
    p = params["params"]
    # Dense kernel [in, out] → Linear weight [out, in]
    q = np.asarray(p["text_encoder"]["encoder"]["attn_0"]["conv_q"]["kernel"])
    np.testing.assert_array_equal(state["text_encoder.encoder.attn.0.conv_q.weight"].numpy(), q.T)
    # wrapped Conv1d kernel [k, in, out] → Conv1d weight [out, in, k]
    w = np.asarray(p["flow"]["flow_1"]["enc"]["in_layer_1"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(state["flow.flow.1.enc.in_layer.1.weight"].numpy(),
                                  w.transpose(2, 1, 0))
    # depthwise conv [k, 1, C] → [C, 1, k]; wrapped LayerNorm scale → weight
    dp = p["duration_predictor"]
    np.testing.assert_array_equal(
        state["duration_predictor.flow.2.convs.conv_sep.1.weight"].numpy(),
        np.asarray(dp["flow_2"]["convs"]["conv_sep_1"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["duration_predictor.convs.norm2.0.weight"].numpy(),
        np.asarray(dp["convs"]["norm2_0"]["LayerNorm_0"]["scale"]))
    # the upsampling ConvTranspose kernel is flipped back in time
    up = np.asarray(p["waveform_decoder"]["ups_0"]["kernel"])
    np.testing.assert_array_equal(state["waveform_decoder.ups.0.weight"].numpy(),
                                  up.transpose(1, 2, 0)[:, :, ::-1])


def test_text_encoder_matches_jax(pair):
    jm, params, port = pair
    x, xl = _text_batch()
    want = jm.module.apply(params, jnp.asarray(x), jnp.asarray(xl),
                           method=lambda m, x, xl: m.text_encoder(x, xl))
    got = port.module.text_encoder(torch.from_numpy(x).long(), torch.from_numpy(xl))
    for name, g, w in zip(("h", "m_p", "logs_p", "x_mask"), got, want):
        _close(g, w, ATOL, name)


def test_reverse_flow_matches_jax(pair):
    jm, params, port = pair
    rs = np.random.RandomState(1)
    z = rs.randn(2, 40, 32).astype(np.float32)
    mask = (np.arange(40)[None, :] < np.array([40, 27])[:, None]).astype(np.float32)[..., None]
    want = jm.module.apply(params, jnp.asarray(z), jnp.asarray(mask),
                           method=lambda m, z, mask: m.flow(z, mask, reverse=True))
    got = port.module.flow(torch.from_numpy(z), torch.from_numpy(mask))
    _close(got, want, ATOL, "reverse flow")


def test_posterior_encoder_matches_jax(pair):
    """Linear spectrogram → latent on the JAX package's noise (built so
    that weights load strictly; voice conversion and training will call it)."""
    jm, params, port = pair
    rs = np.random.RandomState(7)
    y = rs.randn(2, 30, 65).astype(np.float32)
    yl = np.array([30, 21], np.int32)
    with record_jax_normals() as draws:
        want = jm.module.apply(params, jnp.asarray(y), jnp.asarray(yl),
                               method=lambda m, y, yl: m.posterior_encoder(y, yl),
                               rngs={"noise": jax.random.PRNGKey(8)})
    assert [d.shape for d in draws] == [(2, 30, 32)]
    with replay_normals(draws):
        got = port.module.posterior_encoder(torch.from_numpy(y), torch.from_numpy(yl),
                                            torch.Generator())
    for name, g, w in zip(("z", "mean", "log_scale", "y_mask"), got, want):
        _close(g, w, ATOL, name)


def test_waveform_decoder_matches_jax(pair):
    """The shared HiFiGAN generator as VITS builds it (no bias on
    ``conv_post``, no inference padding) and calls it (``g=None``, no frame
    mask)."""
    jm, params, port = pair
    z = np.random.RandomState(6).randn(2, 24, 32).astype(np.float32)
    want = jm.module.apply(params, jnp.asarray(z), method=lambda m, z: m.waveform_decoder(z))
    got = port.module.waveform_decoder(torch.from_numpy(z))
    assert got.shape == (2, 24 * 16, 1)
    _close(got, want, WAV_ATOL, "waveform decoder")


def test_duration_predictor_reverse_matches_jax(pair):
    """The stochastic duration predictor's inference direction, on the JAX
    package's noise at the default noise scale (1.0)."""
    jm, params, port = pair
    rs = np.random.RandomState(2)
    h = rs.randn(2, 16, 32).astype(np.float32)
    mask = (np.arange(16)[None, :] < np.array([16, 9])[:, None]).astype(np.float32)[..., None]
    with record_jax_normals() as draws:
        want = jm.module.apply(
            params, jnp.asarray(h), jnp.asarray(mask),
            method=lambda m, h, mask: m.duration_predictor(h, mask, reverse=True),
            rngs={"noise": jax.random.PRNGKey(3)},
        )
    assert [d.shape for d in draws] == [(2, 16, 2)]
    gen = torch.Generator().manual_seed(0)
    with replay_normals(draws):
        got = port.module.duration_predictor(torch.from_numpy(h), torch.from_numpy(mask), gen)
    _close(got, want, ATOL, "log-durations")


@pytest.mark.parametrize("use_sdp", [True, False], ids=["sdp", "deterministic_dp"])
def test_inference_matches_jax_with_replayed_noise(use_sdp):
    """``VitsModule.inference`` end to end at the default noise scales
    (0.667 prior, 1.0 durations): durations and ``y_lengths`` equal, the
    waveform within 1e-4."""
    jm, params = tiny_jax_vits(seed=1, use_sdp=use_sdp)
    port = port_of(jm, params)
    x, xl = _text_batch(seed=3)
    with record_jax_normals() as draws:
        want = jm.inference(params, jnp.asarray(x), jnp.asarray(xl), max_frames=96)
    assert [d.shape for d in draws] == ([(2, 16, 2)] if use_sdp else []) + [(2, 96, 32)]
    with replay_normals(draws):
        got = port.inference(torch.from_numpy(x).long(), torch.from_numpy(xl), max_frames=96)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    assert (got["durations"] > 1).any()  # the path expands tokens, not only one frame each
    for key in ("m_p", "logs_p", "z_p", "z"):
        _close(got[key], want[key], ATOL, key)
    assert got["model_outputs"].shape == (2, 96 * 16, 1)
    _close(got["model_outputs"], want["model_outputs"], WAV_ATOL, "waveform")


def test_infer_durations_matches_inference_and_jax(pair):
    """The durations pass makes the same first draw as ``inference``, so with
    the same generator state both predict the same lengths, equal to the JAX
    package's ``infer_durations``."""
    jm, params, port = pair
    x, xl = _text_batch(seed=4)
    want = np.asarray(jm.infer_durations(params, jnp.asarray(x), jnp.asarray(xl)))
    with record_jax_normals() as draws:
        jm.infer_durations(params, jnp.asarray(x), jnp.asarray(xl))
    xt, xlt = torch.from_numpy(x).long(), torch.from_numpy(xl)
    with replay_normals(draws):
        got = port.infer_durations(xt, xlt)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    dur = port.infer_durations(xt, xlt, generator=gen)
    gen.set_state(state)
    out = port.inference(xt, xlt, max_frames=512, generator=gen)
    np.testing.assert_array_equal(dur.numpy(), out["y_lengths"].numpy())


def test_max_inference_len_caps_the_budget():
    jm, params = tiny_jax_vits(max_inference_len=24)
    port = port_of(jm, params)
    x, xl = _text_batch(seed=3)
    with record_jax_normals() as draws:
        want = jm.inference(params, jnp.asarray(x), jnp.asarray(xl), max_frames=96)
    with replay_normals(draws):
        got = port.inference(torch.from_numpy(x).long(), torch.from_numpy(xl), max_frames=96)
    assert got["model_outputs"].shape == (2, 24 * 16, 1)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], WAV_ATOL, "capped waveform")


def test_fidelity_replay_through_the_ports_converter(tmp_path):
    """The reference-layout state dict of ``vits.npz`` (weight norm
    unfolded, coqui names) saved as ``model.pth`` and loaded by
    ``Vits.load_checkpoint``: ``y_lengths`` exact, the golden waveform within
    max-abs 1e-5 and under 0.5 dB log-mel distance."""
    state, ins, outs, meta = _load("vits")
    config = VitsConfig()
    for k, v in meta["args"].items():
        setattr(config.model_args, k, v)
    config.model_args.inference_noise_scale = 0.0
    config.model_args.inference_noise_scale_dp = 0.0
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}},
               tmp_path / "model.pth")
    port = Vits(config).load_checkpoint(config, checkpoint_dir=str(tmp_path), device="cpu")

    ref_lens = outs["y_lengths"]
    max_frames = int(((ref_lens.max() + 31) // 32) * 32)
    out = port.inference(torch.from_numpy(ins["text"]), torch.from_numpy(ins["text_lengths"]),
                         max_frames=max_frames)
    np.testing.assert_array_equal(out["y_lengths"].numpy(), ref_lens)
    up = meta["upsample_total"]
    ours = out["model_outputs"].numpy()
    ref_cat = np.concatenate([outs["wav"][b, 0, : n * up] for b, n in enumerate(ref_lens)])
    our_cat = np.concatenate([ours[b, : n * up, 0] for b, n in enumerate(ref_lens)])
    assert ref_cat.shape == our_cat.shape
    assert np.abs(ref_cat - our_cat).max() <= 1e-5
    assert _lsd_db(ref_cat, our_cat) < 0.5


@pytest.mark.parametrize("field,value", [
    ("encoder_sample_rate", 11025),
    ("decoder_type", "istft"),
])
def test_unported_variants_raise(field, value):
    """The ``encoder_sample_rate`` and ``istft`` variants are built (their
    inference is held against the JAX package in
    ``test_torch_vits_variants.py``), but the sequence-packed decode still
    refuses them (ROADMAP.md F2)."""
    config = VitsConfig()
    setattr(config.model_args, field, value)
    with torch.device("meta"):
        model = Vits(config)
    assert not model.supports_packed_decode
    with pytest.raises(ValueError, match="ROADMAP"):
        model.inference_packed(None, None, None, None)


def test_unported_paths_raise(pair):
    """What VITS still refuses: ``speaker_wav`` (the speaker encoder, ROADMAP.md
    item 15) and voice conversion on a model without speakers."""
    from tts_tpu_torch.utils.synthesizer import Synthesizer

    _, _, port = pair
    synth = Synthesizer(device="cpu")
    synth.tts_model, synth.tts_config = port, port.config
    with pytest.raises(NotImplementedError, match="item 15"):
        synth.tts("Hello.", speaker_wav="ref.wav")
    with pytest.raises(ValueError, match="multi-speaker"):
        port.voice_conversion(None, None, None, None)
