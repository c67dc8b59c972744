"""The port's DelightfulTTS (``tts_tpu_torch.models.delightful_tts``,
``utils.convert.delightful_tts_from_jax_params``) against the JAX
package's, on the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``: every leaf N(0, 0.1²), norm scales
1 + N(0, 0.1²); the aligner and the prosody encoders included, which the
carrier drops), the duration predictor's output bias at GlowTTS's
``DURATION_BIAS`` (about 6 frames a token), at the small widths of
``tests/test_delightful_tts.py`` (32 wide, 2 heads, one conformer layer a
side; 20 mels; the joint HiFiGAN upsampling [4, 4] from 32 channels, 16
samples a frame). Each layer agrees within 1e-5 on a padded batch; the
positional table equals the JAX one exactly; the acoustic ``inference`` at
B = 2 has equal durations and ``y_lengths`` and mels within 1e-5 (the
durations are rounded at .5, so the test prints the smallest distance of a
predicted duration from a .5 boundary).

F28, settled in the port (``test_f28_the_joint_vocoder_speaks``): the JAX
wrapper computes its joint vocoder's ``waveform`` beside the mel, but the
JAX ``synthesis`` takes ``model_outputs``, the mel, and so the JAX
``Synthesizer`` speaks a DelightfulTTS only through Griffin-Lim or another
vocoder. The port's ``synthesis`` returns the joint vocoder's waveform, cut
at ``y_lengths × hop``, which equals the JAX module's own ``waveform``
within 1e-5.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import drawn_params

from tts_tpu.models.delightful_tts import DelightfulTTS as JaxDelightfulTTS
from tts_tpu.models.delightful_tts import DelightfulTTSConfig as JaxDelightfulTTSConfig
from tts_tpu.models.delightful_tts import acoustic as jax_acoustic
from tts_tpu.utils.synthesis import synthesis as jax_synthesis
from tts_tpu_torch.models.delightful_tts import DelightfulTTS, DelightfulTTSConfig
from tts_tpu_torch.models.delightful_tts import acoustic
from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS
from tts_tpu_torch.utils.convert import delightful_tts_from_jax_params, flax_to_state_dict
from tts_tpu_torch.utils.synthesis import synthesis

ATOL = 1e-5
SCALE = 0.1
SMALL_ARGS = dict(
    num_chars=24, n_hidden_conformer_encoder=32, n_layers_conformer_encoder=1,
    n_heads_conformer_encoder=2, n_hidden_conformer_decoder=32, n_layers_conformer_decoder=1,
    n_heads_conformer_decoder=2, n_hidden_variance_adaptor=32,
    bottleneck_size_u_reference_encoder=16, bottleneck_size_p_reference_encoder=4,
    ref_enc_filters_reference_encoder=[4, 4, 8, 8, 8, 8], ref_enc_gru_size_reference_encoder=8,
    token_num_reference_encoder=3)
SMALL_VOCODER = dict(upsample_rates_decoder=[4, 4], upsample_kernel_sizes_decoder=[8, 8],
                     upsample_initial_channel_decoder=32, resblock_kernel_sizes_decoder=[3],
                     resblock_dilation_sizes_decoder=[[1, 3]], periods_discriminator=[2, 3],
                     discriminator_width_mult=0.125)


def small_config(cls, **args):
    """``cls`` (either package's ``DelightfulTTSConfig``) at the small
    widths; ``args`` overrides ``model_args`` fields."""
    config = cls()
    for k, v in (SMALL_ARGS | args).items():
        setattr(config.model_args, k, v)
    for k, v in SMALL_VOCODER.items():
        setattr(config.vocoder, k, v)
    config.audio.num_mels = 20
    return config


def draw(jm, seed=0):
    """Numpy params of the JAX ``DelightfulTTS`` ``jm`` drawn from ``seed``
    (traced through its training init, never run), the duration bias at
    ``DURATION_BIAS``."""
    params = jax.tree_util.tree_map(np.array, drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                           seed=seed, scale=SCALE))
    params["acoustic"]["params"]["duration_predictor"]["linear_layer"]["bias"] = np.full(
        (1,), DURATION_BIAS, np.float32)
    return params


@pytest.fixture(scope="module")
def small_pair():
    jm = JaxDelightfulTTS(small_config(JaxDelightfulTTSConfig))
    params = draw(jm)
    port = DelightfulTTS(DelightfulTTSConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(delightful_tts_from_jax_params(params))
    return jm, params, port


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"
    return err


def _frames(seed=0, B=2, T=12, C=32):
    """``[B, T, C]`` values and the pad mask (True after 7 frames of row 1)."""
    rs = np.random.RandomState(seed)
    pad = np.zeros((B, T), bool)
    pad[1, 7:] = True
    return rs.randn(B, T, C).astype(np.float32), pad


def _text(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(1, 24, (2, 16)).astype(np.int64), np.array([16, 10], np.int64)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_positional_table_equals_jax():
    """The host table, bit for bit, and its rows do not depend on its
    length (the model reads the first rows of its longest table)."""
    want = np.asarray(jax_acoustic.positional_encoding(32, 300))[0]
    np.testing.assert_array_equal(acoustic.positional_encoding(32, 300), want)
    np.testing.assert_array_equal(acoustic.positional_encoding(32, 1000)[:300], want)


@pytest.mark.parametrize("t1,t2", [(6, 6), (4, 7)])
def test_relative_shift_matches_jax(t1, t2):
    x = np.random.RandomState(1).randn(2, 3, t1, t2).astype(np.float32)
    np.testing.assert_array_equal(
        acoustic.RelativeMultiHeadAttention._relative_shift(torch.from_numpy(x)).numpy(),
        np.asarray(jax_acoustic.RelativeMultiHeadAttention._relative_shift(jnp.asarray(x))))


@pytest.mark.parametrize("speaker", [False, True])
def test_conformer_block_matches_jax(speaker):
    """One conformer block on a padded batch (a 12-frame positional table),
    with and without the ``Conv1dGLU`` speaker conditioning."""
    jm = jax_acoustic.ConformerBlock(32, 2, 7, 24 if speaker else 0, 0.0, 0.3)
    x, pad = _frames()
    spk = np.random.RandomState(2).randn(2, 24).astype(np.float32) if speaker else None
    enc = np.array(jax_acoustic.positional_encoding(32, 12))
    args = (jnp.asarray(x), jnp.asarray(pad), jnp.asarray(pad[:, None, None, :]),
            None if spk is None else jnp.asarray(spk), jnp.asarray(enc))
    params = drawn_params(jm.init, jax.random.PRNGKey(0), *args, scale=0.3)
    port = acoustic.ConformerBlock(32, 2, 7, 24 if speaker else 0, 0.3)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(pad),
                   torch.from_numpy(pad[:, None, None, :]),
                   None if spk is None else torch.from_numpy(spk), torch.from_numpy(enc))
    _close(got, jm.apply(params, *args), what=f"speaker {speaker}")


@pytest.mark.parametrize("kind", ["duration", "pitch_adaptor", "energy_adaptor",
                                  "phoneme_prosody"])
def test_predictors_match_jax(kind):
    """The variance predictor (the duration's), the pitch and energy
    adaptors' inference embedding (the energy's ``emb_features`` 24, the
    pitch's ``n_input``) and the phoneme prosody predictor, on a padded
    batch."""
    x, pad = _frames(3)
    if kind == "duration":
        jm = jax_acoustic.VariancePredictor(24, 1, 5, 0.0, 0.3)
        port = acoustic.VariancePredictor(32, 24, 1, 5, 0.3)
        fn = None
    elif kind == "phoneme_prosody":
        jm = jax_acoustic.PhonemeProsodyPredictor(32, 5, 0.0, 4, 0.3)
        port = acoustic.PhonemeProsodyPredictor(32, 5, 4, 0.3)
        fn = None
    else:
        emb = 24 if kind == "energy_adaptor" else None
        jm = jax_acoustic.VarianceAdaptor(32, 24, 5, 3, 0.0, 0.3, emb_features=emb)
        port = acoustic.VarianceAdaptor(32, 24, 5, 3, 0.3, emb_features=emb)
        fn = "embedding_infer"
    init = (lambda key, a, m: jm.init(key, a, m, method=jm.embedding_infer)) if fn else jm.init
    params = drawn_params(init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad),
                          scale=0.3)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = (port.embedding_infer if fn else port)(torch.from_numpy(x), torch.from_numpy(pad))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(pad),
                    **({"method": jm.embedding_infer} if fn else {}))
    for i, (g, w) in enumerate(zip(got, want) if fn else [(got, want)]):
        _close(g, w, what=f"{kind} output {i}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def half_margin(port, text, lens) -> float:
    """Smallest distance of a valid token's unrounded duration (after the
    floor of 1) from a .5 boundary, from the port's own durations pass."""
    m = port.module.acoustic_model
    captured = {}
    handle = m.duration_predictor.register_forward_hook(
        lambda mod, args, out: captured.update(log=out))
    try:
        with torch.no_grad():
            m.inference(torch.from_numpy(text), torch.from_numpy(lens), max_frames=300)
    finally:
        handle.remove()
    raw = torch.clamp(torch.exp(captured["log"]) - 1, min=1.0)
    raw = raw[torch.arange(text.shape[1])[None] < torch.from_numpy(lens)[:, None]].numpy()
    return float(np.abs(raw - np.floor(raw) - 0.5).min())


def test_acoustic_inference_matches_jax(small_pair):
    """B = 2 (16 and 10 tokens) at a 300-frame budget: durations,
    ``y_lengths``, the predicted pitch and energy, and the mel."""
    jm, params, port = small_pair
    text, lens = _text()
    want = jm.acoustic_model.apply(params["acoustic"], jnp.asarray(text), jnp.asarray(lens),
                                   max_frames=300, method=jm.acoustic_model.inference)
    with torch.no_grad():
        got = port.module.acoustic_model.inference(torch.from_numpy(text),
                                                   torch.from_numpy(lens), max_frames=300)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    assert 20 < int(got["y_lengths"][1]) < int(got["y_lengths"][0]) < 300
    for key in ("pitch", "energy", "alignments"):
        _close(got[key], want[key], what=key)
    err = _close(got["model_outputs"], want["model_outputs"], what="mel")
    margin = half_margin(port, text, lens)
    print(f"DelightfulTTS: y_lengths {got['y_lengths'].tolist()}, mel max abs diff {err:.3g}, "
          f"smallest distance of a duration from a .5 boundary {margin:.3g}")
    assert margin > 1e-4


def test_d_vectors_are_normalised_as_in_jax():
    """A d-vector model: the vector is L2-normalised and conditions every
    conformer block, in both packages alike."""
    jm = JaxDelightfulTTS(small_config(JaxDelightfulTTSConfig, use_d_vector_file=True,
                                       d_vector_dim=12, n_layers_conformer_decoder=0))
    params = draw(jm, seed=1)
    port = DelightfulTTS(DelightfulTTSConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(delightful_tts_from_jax_params(params))
    text, lens = _text(1)
    dvec = 3.0 * np.random.RandomState(4).randn(2, 12).astype(np.float32)
    want = jm.acoustic_model.apply(params["acoustic"], jnp.asarray(text), jnp.asarray(lens),
                                   d_vectors=jnp.asarray(dvec), max_frames=200,
                                   method=jm.acoustic_model.inference)
    with torch.no_grad():
        got = port.module.acoustic_model.inference(torch.from_numpy(text),
                                                   torch.from_numpy(lens),
                                                   d_vectors=torch.from_numpy(dvec),
                                                   max_frames=200)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], what="d-vector mel")


def test_f28_the_joint_vocoder_speaks():
    """F28: the port's ``synthesis`` returns the joint vocoder's waveform
    cut at ``y_lengths × hop`` (hop 16 here), equal within 1e-5 to the JAX
    wrapper's own ``waveform`` on the same budget; the JAX ``synthesis``
    hands back only the mel (``wav`` ``None`` without Griffin-Lim), which
    is what the JAX ``Synthesizer`` then has to speak."""
    text = "Be a voice, not an echo."
    kw = dict(text_cleaner="english_cleaners", use_phonemes=False)
    jm_tok = JaxDelightfulTTS.init_from_config(_grapheme_config(JaxDelightfulTTSConfig, **kw))
    port_tok = DelightfulTTS.init_from_config(_grapheme_config(DelightfulTTSConfig, **kw))
    params = draw(jm_tok)
    port_tok.load_state_dict(delightful_tts_from_jax_params(params))
    jax_out = jax_synthesis(jm_tok, text, params, use_griffin_lim=False)
    assert jax_out["wav"] is None and jax_out["model_outputs"].shape[-1] == 20
    with torch.no_grad():
        got = synthesis(port_tok, text)
    n = int(got["outputs"]["y_lengths"][0])
    assert port_tok.hop_length == 16 and got["wav"].shape == (n * 16,)
    _close(got["outputs"]["mel"][0, :n], jax_out["model_outputs"], what="mel")
    budget = got["outputs"]["mel"].shape[1]
    ids = got["text_inputs"].numpy()
    want = jm_tok.inference(params, jnp.asarray(ids), jnp.asarray([len(port_tok.tokenizer
                                                                       .text_to_ids(text))]),
                            max_frames=budget)
    err = _close(got["wav"], np.asarray(want["waveform"])[0, : n * 16, 0], what="waveform")
    print(f"DelightfulTTS waveform ({n} frames, {n * 16} samples): max abs diff {err:.3g}")
    assert np.abs(got["wav"]).max() > 1e-3


def _grapheme_config(cls, **kw):
    """The small config with the vocabulary's ``num_chars``; ``kw`` sets
    top-level fields (the text front end)."""
    config = small_config(cls, num_chars=None)
    for k, v in kw.items():
        setattr(config, k, v)
    return config


def test_weights_carry_over_strictly(small_pair):
    """Every inference leaf of the JAX params lands in the port's
    state_dict and nothing else does: the aligner and the two prosody
    encoders are dropped; a missing key raises."""
    _, params, port = small_pair
    acoustic_tree = params["acoustic"]["params"]
    assert {"aligner", "utterance_prosody_encoder", "phoneme_prosody_encoder"} <= \
        set(acoustic_tree)
    state = delightful_tts_from_jax_params(params)
    assert not any(k.split(".")[1] in ("aligner", "utterance_prosody_encoder",
                                       "phoneme_prosody_encoder") for k in state)
    assert sorted(state) == sorted(port.module.state_dict())
    missing = dict(state)
    missing.pop("vocoder.conv_post.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        DelightfulTTS(port.config).load_state_dict(missing)


def test_synthesizer_speaks_it_and_the_batcher_refuses_it(tmp_path):
    """From the port's ``model_torch.pt`` and its ``config.json`` the
    ``Synthesizer`` speaks DelightfulTTS through its joint vocoder, without
    a vocoder of its own (F28), at the config's sample rate; the server's
    ``DynamicBatcher`` refuses it (no durations pass to plan a dispatch
    with), so the server serves it serially; a reference-layout file
    raises, naming ROADMAP.md item 16."""
    import json

    from tts_tpu_torch.server.batching import DynamicBatcher
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

    config = _grapheme_config(DelightfulTTSConfig, text_cleaner="english_cleaners",
                              use_phonemes=False)
    model = DelightfulTTS.init_from_config(config).init_params(seed=0, device="cpu")
    torch.save(model.module.state_dict(), tmp_path / "model_torch.pt")
    (tmp_path / "config.json").write_text(json.dumps(model.config.to_dict()))
    synth = Synthesizer(tts_checkpoint=str(tmp_path / "model_torch.pt"),
                        tts_config_path=str(tmp_path / "config.json"), device="cpu")
    assert synth.vocoder_model is None and synth.output_sample_rate == 22050
    wav = np.asarray(synth.tts("Be a voice, not an echo."), np.float32)
    with torch.no_grad():
        want = synthesis(synth.tts_model, "Be a voice, not an echo.")["wav"]
    np.testing.assert_array_equal(wav[:-SENTENCE_GAP], want)
    assert np.abs(want).max() > 0 and len(want) % 16 == 0
    with pytest.raises(ValueError, match="durations pass"):
        DynamicBatcher(synth, max_batch=4)
    torch.save({"model": {"acoustic_model.weight": torch.zeros(1)}}, tmp_path / "model_file.pth")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 16"):
        DelightfulTTS(config).load_checkpoint(
            config, checkpoint_path=str(tmp_path / "model_file.pth"), device="cpu")
