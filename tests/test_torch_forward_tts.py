"""The port's ForwardTTS family (``tts_tpu_torch.layers.feed_forward``,
``models.forward_tts``, the ForwardTTS converters of ``utils.convert``)
against the JAX package's, on the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``: every leaf N(0, 0.05²), norm scales
1 + N(0, 0.05²)), the duration predictor's output bias at ``DURATION_BIAS``
(about 6 frames a token), carried into the port by
``utils.convert.forward_tts_from_jax_params``, at small widths (hidden 32,
2 heads, 2 layers, 16 mel channels). Each layer agrees within 1e-5 on a
padded batch of two unequal lengths; the positional table equals the JAX
one exactly; ``inference`` of FastPitch, FastSpeech, FastSpeech2 and
SpeedySpeech at B = 2 has equal durations and ``y_lengths`` and mels within
1e-5.

Divergences from the JAX package, each named in its test:

* F24: the port's ``ForwardTTS.init_from_config`` attaches a speaker
  manager and mirrors the top level's speaker fields into ``model_args``;
  the JAX one builds no manager, so a speaker-embedding model's speakers
  never reach its module (``test_f24_speaker_embedding_model``);
* F27: a ``d_vector_dim`` other than ``hidden_channels`` raises in the
  port, where the JAX module would add a vector of the wrong width
  (``test_f27_d_vector_width_raises``);
and the aligner, which training runs, comes across with the rest
(``test_weights_carry_over_strictly``; its training:
``test_torch_forward_tts_train.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fidelity_corpus import _load
from test_torch_glow_tts import drawn_params

from tts_tpu.layers import feed_forward as jax_ff
from tts_tpu.models.forward_tts import ForwardTTS as JaxForwardTTS
from tts_tpu.models.forward_tts import config as jax_config
from tts_tpu_torch.layers import feed_forward
from tts_tpu_torch.models.forward_tts import ForwardTTS
from tts_tpu_torch.models.forward_tts import config as port_config
from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    forward_tts_from_jax_params,
    load_reference_forward_tts,
    reference_forward_tts_state,
)

ATOL = 1e-5
FIDELITY_RMSE = 5e-3  # tests/test_fidelity_corpus.py's _mel_metrics bound
FFT = {"hidden_channels_ffn": 48, "num_heads": 2, "num_layers": 2, "dropout_p": 0.0}
CONV = {"kernel_size": 4, "dilations": [1, 2, 1], "num_conv_blocks": 2}
SMALL = dict(num_chars=40, out_channels=16, hidden_channels=32, encoder_params=FFT,
             decoder_params=FFT, duration_predictor_hidden_channels=24,
             pitch_predictor_hidden_channels=24, energy_predictor_hidden_channels=24)
FAMILY = {
    "fast_pitch": "FastPitchConfig",
    "fast_speech": "FastSpeechConfig",
    "fastspeech2": "Fastspeech2Config",
    "speedy_speech": "SpeedySpeechConfig",
}


def small_config(module, model, **kw):
    """``module``'s config class of ``model`` at small widths; SpeedySpeech
    keeps its conv blocks (3 dilations) and its other defaults."""
    config = getattr(module, FAMILY[model])()
    a = config.model_args
    fields = dict(SMALL, **kw)
    if model == "speedy_speech":
        fields.update(encoder_params=CONV, decoder_params=CONV)
    for k, v in fields.items():
        setattr(a, k, v)
    return config


def jax_pair(model="fast_pitch", seed=0, aux=None, **kw):
    """A small JAX ``ForwardTTS`` and its drawn params (:func:`draw_params`)."""
    jm = JaxForwardTTS(small_config(jax_config, model, **kw))
    return jm, draw_params(jm, seed, aux)


def draw_params(jm, seed=0, aux=None):
    """Numpy params of the JAX ``ForwardTTS`` ``jm``, drawn from ``seed``,
    initialised through the training call (aligner included) with ``aux``
    so that ``emb_g`` exists; the duration bias at ``DURATION_BIAS``."""
    a = jm.args
    t_de = 24
    y = jnp.zeros((1, t_de, a.out_channels))
    frame = jnp.zeros((1, t_de, 1)) if a.use_pitch else None
    energy = jnp.zeros((1, t_de, 1)) if a.use_energy else None

    def init(key):
        return jm.module.init(key, jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
                              jnp.array([t_de]), y=y, dr=jnp.full((1, 8), 3.0), pitch=frame,
                              energy=energy, aux_input=aux)

    params = jax.tree_util.tree_map(np.asarray, drawn_params(init, jax.random.PRNGKey(0),
                                                             seed=seed))
    params["params"]["duration_predictor"]["proj"]["bias"] = np.full((1,), DURATION_BIAS,
                                                                     np.float32)
    return params


def port_of(jm, params) -> ForwardTTS:
    config = port_config.__dict__[type(jm.config).__name__].from_dict(jm.config.to_dict())
    port = ForwardTTS(config)
    port.load_state_dict(forward_tts_from_jax_params(params))
    return port


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"


def _frames(seed, C, B=2, T=12):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T - 5:] = 0
    return x, mask


def _text(seed=0, B=2, T=16):
    rs = np.random.RandomState(seed)
    return rs.randint(1, 40, (B, T)).astype(np.int64), np.array([T, T - 6][:B], np.int64)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer(kind):
    """(JAX module, port module, kwargs of the JAX call) for one layer."""
    if kind == "fft_layer":
        return (jax_ff.FFTransformerLayer(in_out_channels=32, num_heads=2, hidden_channels_ffn=48,
                                          dropout_p=0.0),
                feed_forward.FFTransformerLayer(32, 2, 48))
    if kind == "fft_block":
        return (jax_ff.FFTransformerBlock(in_out_channels=32, num_heads=2, hidden_channels_ffn=48,
                                          num_layers=2, dropout_p=0.0),
                feed_forward.FFTransformerBlock(32, 2, 48, 2))
    if kind == "residual_conv_bn":
        return (jax_ff.ResidualConv1dBNBlock(hidden_channels=32, out_channels=32, kernel_size=4,
                                             dilations=(1, 2, 4)),
                feed_forward.ResidualConv1dBNBlock(32, 32, 4, (1, 2, 4)))
    return (jax_ff.PositionalEncoding(channels=32, use_scale=True),
            feed_forward.PositionalEncoding(32, use_scale=True))


@pytest.mark.parametrize("kind", ["fft_layer", "fft_block", "residual_conv_bn",
                                  "positional_encoding"])
def test_layer_on_a_padded_batch_matches_jax(kind):
    """Each layer on two rows of 12 and 7 valid frames (the FFT layer with
    its key padding mask, the others with the frame mask); every leaf
    drawn, the positional encoding's ``scale`` too."""
    x, mask = _frames(1, 32)
    jm, port = _layer(kind)
    call = {"key_padding_mask": mask[..., 0] < 0.5} if kind == "fft_layer" else {"mask": mask} \
        if kind in ("fft_block", "positional_encoding") else {"x_mask": mask}
    params = drawn_params(jm.init, jax.random.PRNGKey(0), x, seed=2, scale=0.2, **call)
    port.load_state_dict(forward_tts_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), *[torch.from_numpy(np.asarray(v)) for v in call.values()])
    _close(got, jm.apply(params, x, **call), ATOL, kind)


def test_positional_table_equals_jax_exactly():
    """The port's table (float64 numpy, cast once) is the JAX module's, bit
    for bit, over the whole 5000 positions; a float32 ``torch.sin`` of the
    same arguments is not."""
    channels, T = 384, 5000
    jm = jax_ff.PositionalEncoding(channels=channels)
    want = np.asarray(jm.apply({}, jnp.zeros((1, T, channels))))[0]
    got = feed_forward.PositionalEncoding(channels).pe.numpy()
    np.testing.assert_array_equal(got, want)
    position = torch.arange(T, dtype=torch.float32)[:, None]
    div = torch.pow(10000.0, torch.arange(0, channels, 2, dtype=torch.float32) / channels)
    assert np.abs(torch.sin(position * div).numpy() - want[:, 0::2]).max() > 1e-3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", list(FAMILY))
def test_inference_matches_jax(model):
    """``inference`` at B = 2 (16 and 10 tokens) with a 256-frame budget:
    durations and ``y_lengths`` equal, the mel within 1e-5; tokens of about
    6 frames."""
    jm, params = jax_pair(model, seed=3)
    port = port_of(jm, params)
    x, lengths = _text(4)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths), max_frames=256)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    assert np.all((got["y_lengths"].numpy() / lengths > 4) & (got["y_lengths"].numpy() / lengths < 8))
    _close(got["model_outputs"], want["model_outputs"], ATOL, f"{model} mel")
    _close(got["alignments"], want["alignments"], 0, f"{model} alignments")


def test_frame_budget_cuts_as_jax():
    """A budget below the predicted lengths cuts ``y_lengths`` there, in
    both packages."""
    jm, params = jax_pair("fast_pitch", seed=5)
    port = port_of(jm, params)
    x, lengths = _text(6)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths), max_frames=40)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=40)
    assert list(got["y_lengths"]) == [40, 40] == list(np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], ATOL, "cut mel")


def write_ids(path, names):
    path.write_text(json.dumps({name: i for i, name in enumerate(names)}))
    return str(path)


def test_f24_speaker_embedding_model(tmp_path):
    """F24: the VCTK FastPitch recipe's fields (``use_speaker_embedding`` on
    the top level, a speakers file): the port's ``init_from_config`` builds
    the speaker manager and ``emb_g``, and its decode with each speaker
    equals the JAX module's given the speaker id by hand; the JAX wrapper
    builds no manager and no ``emb_g``, so its recipe model decodes with no
    speaker."""
    speakers = write_ids(tmp_path / "speakers.json", ["p225", "p226", "p227"])
    recipe = dict(use_speaker_embedding=True, speakers_file=speakers, use_phonemes=False,
                  text_cleaner="english_cleaners")
    jax_recipe = small_config(jax_config, "fast_pitch", num_chars=None)
    for k, v in recipe.items():
        setattr(jax_recipe, k, v)
    jax_model = JaxForwardTTS.init_from_config(jax_recipe)
    assert getattr(jax_model, "speaker_manager", None) is None
    assert not jax_model.args.use_speaker_embedding

    port_recipe = port_config.FastPitchConfig.from_dict(jax_recipe.to_dict())
    port = ForwardTTS.init_from_config(port_recipe)
    assert port.speaker_manager.speaker_names == ["p225", "p226", "p227"]
    assert port.args.use_speaker_embedding and port.args.num_speakers == 3
    assert port.module.emb_g.weight.shape == (3, 32)

    n_chars = port.args.num_chars
    ids = jnp.asarray([0, 2])
    jm, params = jax_pair("fast_pitch", seed=7, aux={"speaker_ids": ids}, num_chars=n_chars,
                          use_speaker_embedding=True, num_speakers=3)
    port.load_state_dict(forward_tts_from_jax_params(params))
    x, lengths = _text(8)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths),
                        aux_input={"speaker_ids": ids}, max_frames=256)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256,
                             aux_input={"speaker_ids": torch.tensor([0, 2])})
        none = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], ATOL, "speaker mel")
    assert np.abs(none["model_outputs"].numpy() - got["model_outputs"].numpy()).max() > 1e-3


def test_f27_d_vector_width_raises():
    """F27: d-vectors of another width than ``hidden_channels`` raise when
    the model is built, naming F27; the width of ``hidden_channels`` is
    taken and adds the vector as the JAX module does."""
    config = small_config(port_config, "fast_pitch", use_d_vector_file=True, d_vector_dim=16)
    with pytest.raises(NotImplementedError, match="F27"):
        ForwardTTS(config)
    config.use_d_vector_file, config.d_vector_dim = True, 16  # the top level, F11's rule
    config.model_args.use_d_vector_file, config.model_args.d_vector_dim = False, None
    with pytest.raises(NotImplementedError, match="F27"):
        ForwardTTS.init_from_config(config)

    d = np.random.RandomState(9).randn(2, 32).astype(np.float32)
    jm, params = jax_pair("fast_pitch", seed=9, use_d_vector_file=True, d_vector_dim=32)
    port = port_of(jm, params)
    x, lengths = _text(10)
    want = jm.inference(params, jnp.asarray(x), jnp.asarray(lengths),
                        aux_input={"d_vectors": jnp.asarray(d)}, max_frames=256)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256,
                             aux_input={"d_vectors": torch.from_numpy(d)})
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], ATOL, "d-vector mel")


def test_fidelity_replay_through_the_ports_converter(tmp_path):
    """``fastpitch.npz`` (the reference's state, aligner and positional
    table included) saved as ``model_file.pth`` and loaded by
    ``ForwardTTS.load_checkpoint``: the reference's frame count, and the mel
    under ``test_fidelity_corpus``'s RMSE bound."""
    state, ins, outs, meta = _load("fastpitch")
    config = port_config.FastPitchConfig()
    a = config.model_args
    a.num_chars, a.out_channels, a.hidden_channels = 40, 20, 32
    a.duration_predictor_hidden_channels = a.pitch_predictor_hidden_channels = 48
    a.encoder_params = a.decoder_params = {"hidden_channels_ffn": 64, "num_heads": 2,
                                           "num_layers": 2, "dropout_p": 0.0}
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}},
               tmp_path / "model_file.pth")
    port = ForwardTTS(config).load_checkpoint(config, checkpoint_dir=str(tmp_path), device="cpu")
    with torch.no_grad():
        out = port.inference(torch.from_numpy(ins["text"]).long(),
                             torch.from_numpy(ins["text_lengths"]).long(), max_frames=64)
    ref = outs["mel"][0]
    T = int(out["y_lengths"][0])
    assert T == ref.shape[0]
    assert float(np.sqrt(np.mean((out["model_outputs"][0, :T].numpy() - ref) ** 2))) < FIDELITY_RMSE


def test_reference_layout_round_trip():
    """``reference_forward_tts_state`` writes the names and shapes of
    ``fastpitch.npz`` (the aligner's ``key_layer``/``query_layer`` among
    them; the positional table as the reference's ``[1, C, 5000]`` buffer),
    and ``load_reference_forward_tts`` reads them back to the same
    tensors."""
    jm, params = jax_pair("fast_pitch", seed=11)
    port = port_of(jm, params)
    state = port.module.state_dict()
    ref = reference_forward_tts_state(state, port.module.pos_encoder.pe)
    fixture, _, _, _ = _load("fastpitch")
    assert set(ref) == set(fixture)
    for k in ref:
        assert ref[k].ndim == fixture[k].ndim, k
    assert ref["pos_encoder.pe"].shape == (1, 32, 5000)
    back = load_reference_forward_tts(ref, port.args)
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k
    config = small_config(port_config, "speedy_speech")
    with pytest.raises(NotImplementedError, match="item 16"):
        load_reference_forward_tts(ref, config.model_args)


def test_weights_carry_over_strictly():
    """The port's state_dict takes every JAX leaf, the aligner's (which
    training runs) among them, and nothing else; the attention's flax
    Denses pack into ``in_proj_weight``."""
    jm, params = jax_pair("fastspeech2", seed=12)
    assert "aligner" in params["params"]
    port = port_of(jm, params)
    carried = forward_tts_from_jax_params(params)
    assert set(port.module.state_dict()) == set(carried)
    assert {k for k in carried if k.startswith("aligner")} == {
        f"aligner.{c}.{leaf}" for c in ("key_conv1", "key_conv2", "query_conv1", "query_conv2",
                                        "query_conv3") for leaf in ("weight", "bias")}
    assert carried["encoder.fft_0.self_attn.in_proj_weight"].shape == (96, 32)
    flat = flax_to_state_dict({k: v for k, v in params["params"].items()
                               if k not in ("encoder", "decoder")})
    for k, v in flat.items():
        assert torch.equal(carried[k], v), k


def test_init_params_speaks_at_the_recipes_pace():
    """``init_params`` (what ``chip_smoke.py`` builds at full width): tokens
    of about 6 frames and a finite mel."""
    config = small_config(port_config, "fast_pitch")
    model = ForwardTTS(config).init_params(seed=0, device="cpu")
    x, lengths = _text(13)
    with torch.no_grad():
        out = model.inference(torch.from_numpy(x), torch.from_numpy(lengths), max_frames=256)
    per_token = out["y_lengths"].numpy() / lengths
    assert np.all((per_token > 4.5) & (per_token < 7.5)), per_token
    assert torch.isfinite(out["model_outputs"]).all()
