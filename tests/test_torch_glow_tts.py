"""The port's GlowTTS (``tts_tpu_torch.layers.glow``, ``layers.common.ConvLayerNormBlock``,
``models.glow_tts``) against the JAX package's, on the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(:func:`drawn_params`, which draws every leaf, biases and log-scales
included, so the leaves that the JAX init starts at zero, each coupling's
``end``, the prenet's ``proj`` and ``ActNorm``'s ``logs`` and ``bias``, are
non-zero and the flows and WaveNets do work), each ``InvConvNear`` weight
made orthogonal as the JAX init makes it, and the duration predictor's output bias set so that a token lasts
about 6 frames (``DURATION_BIAS``), then carried into the port by
``utils.convert.glow_tts_from_jax_params``. Layers match within 1e-5 in each
direction, the decoder's forward-then-reverse round trip within 1e-4, and
inference (plain, with learned speakers, with d-vectors) has equal
``y_lengths`` and mels within 1e-5.

Divergence from the JAX package, named in its test (ROADMAP.md F18): the
JAX module adds ``inference_noise_scale`` noise only when handed a
``noise_rng``, which neither its host wrapper nor its ``synthesis`` passes,
so it always decodes the mean; the port applies the noise, drawn from a
``torch.Generator`` or passed in. On shared noise the port equals the JAX
module called with a ``noise_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fidelity_corpus import _load

from tts_tpu.layers import common as jax_common
from tts_tpu.layers import glow as jax_glow
from tts_tpu.models.glow_tts.config import GlowTTSConfig as JaxGlowTTSConfig
from tts_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from tts_tpu_torch.layers import glow
from tts_tpu_torch.layers.common import ConvLayerNormBlock
from tts_tpu_torch.models.glow_tts import GlowTTS, GlowTTSConfig
from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    glow_tts_from_jax_params,
    load_reference_glow_tts,
    reference_glow_tts_state,
)

ATOL = 1e-5
WEIGHT_SCALE = 0.05
ENCODER = {"kernel_size": 3, "dropout_p": 0.0, "num_layers": 2, "num_heads": 2,
           "hidden_channels_ffn": 48}


def drawn_params(init_fn, *args, seed=0, scale=WEIGHT_SCALE, **kwargs):
    """Numpy params of ``init_fn``'s structure (traced, never run), every
    float leaf drawn N(0, scale²), norm scales 1 + N(0, scale²)."""
    shapes = jax.eval_shape(init_fn, *args, **kwargs)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        draw = (rs.standard_normal(leaf.shape) * scale).astype(leaf.dtype)
        return draw + 1 if getattr(path[-1], "key", "") == "scale" else draw

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_glow_kw(**kw):
    """Small ``GlowTTSConfig`` fields; ``kw`` adds or overrides."""
    return dict(out_channels=16, hidden_channels_enc=32, hidden_channels_dec=24,
                hidden_channels_dp=32, encoder_params=dict(ENCODER), num_flow_blocks_dec=2,
                num_block_layers=2) | kw


def as_glow_params(params, seed: int = 0):
    """Numpy flax params with each ``InvConvNear`` weight orthogonal (the
    JAX init's QR of a normal draw) and the duration predictor's output
    bias at ``DURATION_BIAS``."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(seed)
    for name, leaf in params["params"]["dec"].items():
        if name.startswith("invconv"):
            s = leaf["weight"].shape[0]
            leaf["weight"] = np.linalg.qr(rs.randn(s, s))[0].astype(np.float32)
    params["params"]["enc"]["duration_predictor"]["proj"]["bias"] = np.full(
        (1,), DURATION_BIAS, np.float32)
    return params


def tiny_jax_glow(seed=0, aux=None, **kw):
    """A tiny JAX ``GlowTTS`` and its params (:func:`drawn_params`, then
    :func:`as_glow_params`), initialised with ``aux`` so that the speaker
    layers exist."""
    model = JaxGlowTTS(JaxGlowTTSConfig(**tiny_glow_kw(**kw)))
    b = len(next(iter(aux.values()))) if aux else 1
    x = jnp.zeros((b, 16), jnp.int32)
    y = jnp.zeros((b, 32, model.config.out_channels), jnp.float32)

    def init(key):
        return model.module.init(key, x, jnp.full((b,), 16), y, jnp.full((b,), 32),
                                 aux_input=aux)

    return model, as_glow_params(drawn_params(init, jax.random.PRNGKey(0), seed=seed), seed)


def port_glow(jax_model, params) -> GlowTTS:
    port = GlowTTS(GlowTTSConfig.from_dict(jax_model.config.to_dict()))
    port.load_state_dict(glow_tts_from_jax_params(params))
    return port


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, f"{what}: max abs diff {err}"


def _text(seed=0, B=2, T=16, vocab=40):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, vocab, (B, T)).astype(np.int64)
    lengths = np.array([T, T - 5][:B], np.int64)
    return x, lengths


@pytest.fixture(scope="module")
def pair():
    jm, params = tiny_jax_glow(seed=1, num_chars=40)
    return jm, params, port_glow(jm, params)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _frames(seed, C, B=2, T=12):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T - 4:] = 0
    return x, mask


def test_conv_layer_norm_block_matches_jax():
    """The prenet block, its zero-initialised ``proj`` drawn non-zero."""
    x, mask = _frames(0, 24)
    jm = jax_common.ConvLayerNormBlock(hidden_channels=20, out_channels=24, kernel_size=5,
                                       num_layers=3)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), x, mask, seed=3, scale=0.2)
    assert np.abs(np.asarray(params["params"]["proj"]["kernel"])).max() > 0
    port = ConvLayerNormBlock(24, 20, 24, kernel_size=5, num_layers=3)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, jm.apply(params, x, mask), ATOL, "ConvLayerNormBlock")


def _flow_layer(kind):
    """(JAX module, port module, its call kwargs) for one flow layer, 16
    channels, the coupling conditioned on an 8-wide vector."""
    if kind == "actnorm":
        return jax_glow.ActNorm(channels=16), glow.ActNorm(16), {}
    if kind == "invconv":
        return jax_glow.InvConvNear(channels=16, num_splits=4), glow.InvConvNear(16, 4), {}
    g = np.random.RandomState(7).randn(2, 8).astype(np.float32)
    return (jax_glow.CouplingBlock(in_channels=16, hidden_channels=12, kernel_size=3,
                                   dilation_rate=2, num_layers=3, c_in_channels=8),
            glow.CouplingBlock(16, 12, 3, 2, 3, c_in_channels=8), {"g": g})


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("kind", ["actnorm", "invconv", "coupling"])
def test_flow_layer_matches_jax(kind, reverse):
    """Each flow in each direction, with its log-determinant forward; the
    coupling's zero-initialised ``end`` and ``ActNorm``'s terms drawn
    non-zero, the invertible convolution's weight orthogonal."""
    x, mask = _frames(1, 16)
    jm, port, kw = _flow_layer(kind)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), x, mask, seed=4, scale=0.2, **kw)
    if kind == "invconv":
        params["params"]["weight"] = np.linalg.qr(
            np.random.RandomState(2).randn(4, 4))[0].astype(np.float32)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    want_z, want_logdet = jm.apply(params, x, mask, reverse=reverse, **kw)
    with torch.no_grad():
        got_z, got_logdet = port(torch.from_numpy(x), torch.from_numpy(mask),
                                 reverse=reverse, **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got_z, want_z, ATOL, f"{kind} z")
    if reverse:
        assert got_logdet is None and want_logdet is None
    else:
        _close(got_logdet, want_logdet, 1e-4, f"{kind} logdet")


def test_decoder_round_trip_and_forward_match_jax(pair):
    """The whole flow decoder forward (against the JAX decoder, logdet
    included), then back: the round trip returns the input within 1e-4
    where the mask is on."""
    jm, params, port = pair
    x, mask = _frames(2, 16, T=20)
    c = jm.config
    want_z, want_logdet, _ = jax_glow.GlowDecoder(
        in_channels=c.out_channels, hidden_channels=c.hidden_channels_dec,
        kernel_size=c.kernel_size_dec, dilation_rate=c.dilation_rate,
        num_flow_blocks=c.num_flow_blocks_dec, num_coupling_layers=c.num_block_layers,
    ).apply({"params": params["params"]["dec"]}, x, mask)
    with torch.no_grad():
        z, logdet, z_mask = port.module.dec(torch.from_numpy(x), torch.from_numpy(mask))
        back, none, _ = port.module.dec(z, z_mask, reverse=True)
    _close(z, want_z, ATOL, "decoder forward")
    _close(logdet, want_logdet, 1e-4, "decoder logdet")
    assert none is None
    _close(back * z_mask, x * z_mask.numpy(), 1e-4, "round trip")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_weights_carry_over_strictly(pair):
    jm, params, port = pair
    state = port.module.state_dict()
    assert set(state) == set(glow_tts_from_jax_params(params))
    for name in ("enc.prenet.proj.weight", "dec.coupling_0.end.weight", "dec.actnorm_1.logs",
                 "dec.actnorm_1.bias"):
        assert state[name].abs().max() > 0, name  # zero at the JAX init, drawn here


@pytest.mark.parametrize("cond", ["plain", "speakers", "d_vectors"])
def test_inference_matches_jax(cond):
    """``GlowTTSModule.inference`` at a 256-frame budget: ``y_lengths``
    equal, the mel within 1e-5; speakers through ``emb_g`` (3 speakers) or
    8-wide d-vectors, L2-normalised in both."""
    x, lengths = _text(3)
    aux = None
    kw = {}
    if cond == "speakers":
        aux = {"speaker_ids": np.array([2, 0])}
        kw = dict(use_speaker_embedding=True, num_speakers=3)
    elif cond == "d_vectors":
        aux = {"d_vectors": np.random.RandomState(5).randn(2, 8).astype(np.float32)}
        kw = dict(c_in_channels=8, use_d_vector_file=True, d_vector_dim=8)
    jm, params = tiny_jax_glow(seed=2, aux=None if aux is None else {
        k: jnp.asarray(v) for k, v in aux.items()}, num_chars=40, **kw)
    port = port_glow(jm, params)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths),
                        aux_input=aux and {k: jnp.asarray(v) for k, v in aux.items()},
                        max_frames=256)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256,
                             aux_input=aux and {k: torch.from_numpy(v) for k, v in aux.items()})
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    assert 40 < int(got["y_lengths"].min()) < 128  # ~6 frames a token
    _close(got["model_outputs"], want["model_outputs"], ATOL, f"mel ({cond})")
    _close(got["alignments"], want["alignments"], 0, "alignments")


def test_frame_budget_cuts_as_jax(pair):
    """A budget below the predicted length cuts ``y_lengths`` there, in
    both packages."""
    jm, params, port = pair
    x, lengths = _text(4)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths), max_frames=32)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=32)
    assert list(got["y_lengths"]) == [32, 32] == list(np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], ATOL, "cut mel")


def test_f18_inference_noise_scale_on_shared_noise():
    """F18: at ``inference_noise_scale`` 0.5 the port adds ``exp(y_log_scale)
    · ε · 0.5`` to the prior (``mean_only=False``, so the log-scale works);
    on the JAX module's own ``jax.random.normal(key, shape)`` draw it equals
    the JAX module called with that ``noise_rng``. The JAX host wrapper
    passes no ``noise_rng`` and decodes the mean, which the port's wrapper
    (drawing ε from a generator) does not."""
    x, lengths = _text(5)
    jm, params = tiny_jax_glow(seed=3, num_chars=40, inference_noise_scale=0.5, mean_only=False)
    port = port_glow(jm, params)
    key = jax.random.PRNGKey(11)
    frames = 256
    want = jm.module.apply(params, jnp.asarray(x), jnp.asarray(lengths), max_frames=frames,
                           noise_rng=key, method=jm.module.inference)
    eps = np.array(jax.random.normal(key, (2, frames, 16)))
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=frames,
                             noise=torch.from_numpy(eps))
        drawn = port.inference(torch.from_numpy(x), torch.from_numpy(lengths),
                               max_frames=frames)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], ATOL, "noisy mel")
    jax_wrapper = np.asarray(jm.inference(params, jnp.asarray(x), jnp.asarray(lengths),
                                          max_frames=frames)["model_outputs"])
    mean_only = jm.module.apply(params, jnp.asarray(x), jnp.asarray(lengths), max_frames=frames,
                                method=jm.module.inference)
    _close(jax_wrapper, mean_only["model_outputs"], 0, "JAX wrapper decodes the mean")
    assert np.abs(drawn["model_outputs"].numpy() - jax_wrapper).max() > 1e-2


def test_fidelity_replay_through_the_ports_converter(tmp_path):
    """``glow_tts.npz`` (reference layout, weight norm unfolded) saved as
    ``model_file.pth`` and loaded by ``GlowTTS.load_checkpoint``:
    ``y_lengths`` equal and mel RMSE under 5e-3, ``test_fidelity_corpus``'s
    thresholds."""
    state, ins, outs, meta = _load("glow_tts")
    config = GlowTTSConfig()
    for k, v in meta["config"].items():
        setattr(config, k, v)
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}},
               tmp_path / "model_file.pth")
    port = GlowTTS(config).load_checkpoint(config, checkpoint_dir=str(tmp_path), device="cpu")
    ref_lens = outs["y_lengths"]
    max_frames = int(((ref_lens.max() + 31) // 32) * 32)
    with torch.no_grad():
        out = port.inference(torch.from_numpy(ins["text"]),
                             torch.from_numpy(ins["text_lengths"]), max_frames=max_frames)
    np.testing.assert_array_equal(out["y_lengths"].numpy(), ref_lens)
    ours = np.concatenate([out["model_outputs"][b, :n].numpy() for b, n in enumerate(ref_lens)])
    ref = np.concatenate([outs["mel"][b, :n] for b, n in enumerate(ref_lens)])
    assert float(np.sqrt(np.mean((ref - ours) ** 2))) < 5e-3


def test_reference_layout_round_trip(pair):
    """``reference_glow_tts_state`` writes the reference names and shapes
    (those of ``glow_tts.npz``), and ``load_reference_glow_tts`` reads them
    back to the same tensors."""
    jm, params, port = pair
    state = port.module.state_dict()
    ref = reference_glow_tts_state(state)
    fixture, _, _, _ = _load("glow_tts")
    kinds = {k.rsplit(".", 1)[-1] for k in fixture}
    assert {k.rsplit(".", 1)[-1] for k in ref} <= kinds | {"weight"}
    assert ref["decoder.flows.0.logs"].shape == (1, 32, 1)
    assert ref["encoder.encoder.attn_layers.0.conv_q.weight"].shape == (32, 32, 1)
    back = load_reference_glow_tts(ref, port.config)
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


def test_init_params_speaks_at_the_recipes_pace():
    """``init_params`` (what ``chip_smoke.py`` builds at full width): every
    zero-initialised leaf drawn, each ``InvConvNear`` orthogonal, and tokens
    of about 6 frames."""
    config = GlowTTSConfig(num_chars=40, **tiny_glow_kw())
    model = GlowTTS(config).init_params(seed=0, device="cpu")
    state = model.module.state_dict()
    for k, v in state.items():
        if k.endswith((".end.weight", "prenet.proj.weight", ".logs")):
            assert v.abs().max() > 0, k
    w = state["dec.invconv_0.weight"]
    torch.testing.assert_close(w @ w.T, torch.eye(4), atol=1e-5, rtol=0)
    x, lengths = _text(6)
    with torch.no_grad():
        out = model.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256)
    per_token = out["y_lengths"].numpy() / lengths
    assert np.all((per_token > 4.5) & (per_token < 7.5)), per_token
    assert torch.isfinite(out["model_outputs"]).all()


def test_num_chars_below_the_vocabulary_raises():
    """F7's rule: the tokenizer sizes the embedding; a smaller ``num_chars``
    raises."""
    config = GlowTTSConfig(num_chars=10, text_cleaner="english_cleaners", use_phonemes=False,
                           **tiny_glow_kw())
    with pytest.raises(ValueError, match="smaller than the"):
        GlowTTS.init_from_config(config)
    config.num_chars = None
    model = GlowTTS.init_from_config(config)
    assert model.module.enc.emb.num_embeddings == model.tokenizer.characters.num_chars
