"""The port's Tacotron2 (``tts_tpu_torch.layers.tacotron``,
``models.tacotron2``, the autoregressive branch of ``utils.synthesis``, the
converters of ``utils.convert``) against the JAX package's, on the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``: every leaf N(0, 0.3²), norm scales
1 + N(0, 0.3²); the ConvBN convs then at unit gain), carried into the port by
``utils.convert.tacotron2_from_jax_params``, at the widths of
``tests/test_tacotron2.py`` (64 wide, prenet 32, attention 32, r = 2).
Layers and single decoder steps agree within 1e-5; the teacher-forced
forward, the free-running decode and ``synthesis`` have equal
``mel_lengths`` and mels within 1e-5 (3e-5 over the 17 steps of the B = 2
decode: ``INFERENCE_ATOL``). The free-running decode's stopnet is
set (``STOP``, weights of seed 1) so that the two rows stop at steps 5 and
17 of a 30-step budget, no stop probability within 1e-3 of 0.5 before them.

Divergences from the JAX package, each named in its test:

* the port's decode leaves once every row has stopped, where the JAX scan
  runs every step and masks; ``alignments`` and ``stop_tokens`` cover only
  the steps that ran (``test_inference_matches_jax``);
* F19: ``prenet_dropout_at_inference`` is followed, with masks from a
  seeded ``torch.Generator``; the JAX package never passes the flag
  (``test_f19_prenet_dropout_at_inference``);
* F20: ``r_init`` comes from the checkpoint's projection and ``r`` from the
  checkpoint's own ``r``; the JAX package takes both from ``config.r``
  (``test_f20_reduction_factor_from_the_checkpoint``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fidelity_corpus import _load
from test_torch_glow_tts import drawn_params

from tts_tpu.layers import tacotron as jax_tacotron
from tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tts_tpu.models.tacotron2 import Tacotron2Config as JaxTacotron2Config
from tts_tpu.models.tacotron2 import Tacotron2Module as JaxTacotron2Module
from tts_tpu.utils.convert import convert_tacotron2 as jax_convert_tacotron2
from tts_tpu.utils.synthesis import synthesis as jax_synthesis
from tts_tpu_torch.layers import tacotron
from tts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tts_tpu_torch.models.tacotron2 import model as t2_model
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    load_reference_tacotron2,
    reference_tacotron2_state,
    tacotron2_from_jax_params,
)
from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis

ATOL = 1e-5
# the free-running decode's mels peak at 6.4; 17 recurrent steps carry fp32
# rounding to 1.7e-5 (2.6e-6 of the peak)
INFERENCE_ATOL = 3e-5
SCALE = 0.3  # weight draw: wide enough that attention and stop logits vary
STOP = (1.0, -2.6)  # the stopnet's bias at -2.6: seed 1's rows stop at steps 5 and 17
FIDELITY_RMSE = 5e-3  # tests/test_fidelity_corpus.py's _mel_metrics bound
ATTENTIONS = {
    "location-sigmoid": {},
    "location-softmax": {"attention_norm": "softmax"},
    "windowing": {"attention_win": True},
    "forward-trans-agent": {"use_forward_attn": True, "transition_agent": True},
    "graves": {"attention_type": "graves"},
    "dca": {"attention_type": "dynamic_convolution", "location_attn": False},
}


def small_config(cls, **kw):
    """``tests/test_tacotron2.py``'s small widths as ``cls`` (either
    package's ``Tacotron2Config``); ``kw`` adds or overrides."""
    return cls(**(dict(num_chars=24, out_channels=80, encoder_in_features=64,
                       decoder_in_features=64, embedding_dim=64, query_dim=64,
                       decoder_rnn_dim=64, prenet_dim=32, attn_dim=32, max_decoder_steps=20,
                       r=2) | kw))


def with_stopnet(params, weight_scale: float, bias: float):
    """Numpy params with the stopnet's kernel scaled and its bias set."""
    params = jax.tree_util.tree_map(np.array, params)
    stopnet = params["params"]["decoder_cell"]["stopnet"]
    stopnet["kernel"] = stopnet["kernel"] * weight_scale
    stopnet["bias"] = np.full_like(stopnet["bias"], bias)
    return params


def unit_gain_convs(params, scale=SCALE):
    """Numpy params drawn at ``scale`` with each ConvBN block's conv kernel
    (encoder and postnet) rescaled to N(0, 1/fan_in): at 0.3 a 5-tap conv over 64
    (512) channels would amplify by ~5 (~15) with each layer, and 1e-6
    differences of its input with it, where a trained block's norm keeps
    the scale."""
    params = jax.tree_util.tree_map(np.array, params)
    for part in ("encoder", "postnet"):
        for name, block in params["params"][part].items():
            if name.startswith("conv_"):
                kernel = block["conv"]["Conv_0"]["kernel"]  # [k, in, out]
                block["conv"]["Conv_0"]["kernel"] = kernel / (scale * np.sqrt(kernel[..., 0].size))
    return params


def jax_pair(seed=0, stop=None, **kw):
    """A JAX ``Tacotron2`` of ``small_config(**kw)``, its drawn params (the
    ConvBN convs at unit gain) and the port's ``Tacotron2`` carrying them."""
    jm = JaxTacotron2(small_config(JaxTacotron2Config, **kw))
    params = unit_gain_convs(drawn_params(jm.init_params, jax.random.PRNGKey(0), seed=seed,
                                          scale=SCALE))
    if stop:
        params = with_stopnet(params, *stop)
    port = Tacotron2(small_config(Tacotron2Config, **kw))
    port.load_state_dict(tacotron2_from_jax_params(params))
    return jm, params, port


def _text(seed=0):
    """Two rows of 16 ids, the second padded after 9, as ``synthesis`` pads."""
    rs = np.random.RandomState(seed)
    return rs.randint(1, 24, (2, 16)), np.array([16, 9])


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prenet_type,bias", [("original", False), ("bn", True)])
def test_prenet_matches_jax(prenet_type, bias):
    """The decoder's prenet (no bias, reference ``tacotron2.py:179``) and
    the ``bn`` kind with bias."""
    jm = jax_tacotron.Prenet((32, 32), prenet_type, use_bias=bias)
    x = np.random.RandomState(1).randn(3, 80).astype(np.float32)
    params = drawn_params(lambda key, v: jm.init(key, v, train=False), jax.random.PRNGKey(0),
                          jnp.asarray(x), scale=SCALE)
    port = tacotron.Prenet(80, (32, 32), prenet_type, bias=bias)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x), train=False),
               what="prenet")


@pytest.mark.parametrize("norm_type", ["layer", "folded"])
def test_conv_bn_block_matches_jax(norm_type):
    jm = jax_tacotron.ConvBNBlock(48, 5, "tanh", norm_type)
    x = np.random.RandomState(2).randn(2, 11, 32).astype(np.float32)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), scale=SCALE)
    port = tacotron.ConvBNBlock(32, 48, 5, "tanh", norm_type)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)), what=norm_type)


def test_encoder_on_a_padded_batch_matches_jax():
    """Two rows of unequal length in one padded batch: the backward LSTM
    starts at each row's true end (the packed ``nn.LSTM`` against the JAX
    encoder's ``seq_lengths``), and padded positions are zero."""
    jm = jax_tacotron.Tacotron2Encoder(64, "layer")
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 48).astype(np.float32)
    mask = (np.arange(16)[None, :] < np.array([16, 9])[:, None])[:, :, None].astype(np.float32)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                          scale=SCALE)
    port = tacotron.Tacotron2Encoder(48, 64, "layer")
    port.load_state_dict(tacotron2_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, jm.apply(params, jnp.asarray(x), jnp.asarray(mask)), what="encoder")
    assert torch.all(got[1, 9:] == 0) and got[1, :9].abs().min() > 0
    # a plain bidirectional LSTM over the padded batch would differ on the short row
    with torch.no_grad():
        h = torch.from_numpy(x * mask)
        for i in range(3):
            h = getattr(port, f"conv_{i}")(h * torch.from_numpy(mask))
        plain = port.lstm(h * torch.from_numpy(mask))[0]
    assert (plain[1, :9] - got[1, :9]).abs().max() > 1e-3


CELL = dict(in_channels=64, frame_channels=80, r=2, query_dim=64, decoder_rnn_dim=64,
            prenet_dim=32, attn_dim=32)
CELL_ATTENTIONS = {
    "location-sigmoid": {"attn_norm": "sigmoid"},
    "location-softmax": {"attn_norm": "softmax"},
    "windowing": {"attn_norm": "sigmoid", "attn_win": True},
    "forward-trans-agent": {"use_forward_attn": True, "trans_agent": True},
    "graves": {"attn_type": "graves"},
    "dca": {"attn_type": "dynamic_convolution", "location_attn": False},
}


@pytest.mark.parametrize("attention", list(CELL_ATTENTIONS))
def test_decoder_steps_match_jax(attention):
    """Three decoder steps from ``init_carry`` for each attention: every
    step's frames, stop logit and alignment, and the final carry."""
    kw = CELL | CELL_ATTENTIONS[attention]
    jcell = jax_tacotron.Tacotron2DecoderCell(**kw)
    rs = np.random.RandomState(4)
    B, T = 2, 16
    enc = rs.randn(B, T, 64).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([16, 9])[:, None]
    processed = rs.randn(B, T, 32).astype(np.float32)
    frames = rs.randn(3, B, 80).astype(np.float32)
    jcarry = jcell.init_carry(B, T, 64)
    params = drawn_params(jcell.init, jax.random.PRNGKey(0), jcarry, jnp.asarray(frames[0]),
                          jnp.asarray(enc), jnp.asarray(processed), jnp.asarray(mask),
                          scale=SCALE)
    port = tacotron.Tacotron2DecoderCell(**kw)
    port.load_state_dict(tacotron2_from_jax_params(params), strict=True)
    pcarry = port.init_carry(B, T, 64)
    args = (torch.from_numpy(enc), torch.from_numpy(processed), torch.from_numpy(mask))
    for t in range(3):
        jcarry, jout = jcell.apply(params, jcarry, jnp.asarray(frames[t]), jnp.asarray(enc),
                                   jnp.asarray(processed), jnp.asarray(mask))
        with torch.no_grad():
            pcarry, pout = port(pcarry, torch.from_numpy(frames[t]), *args)
        for name, got, want in zip(("frames", "stop", "alignment"), pout, jout):
            _close(got, want, what=f"{attention} step {t} {name}")
    for i, (got, want) in enumerate(zip(pcarry, jcarry)):
        _close(got, want, what=f"{attention} carry {i}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["location-sigmoid", "dca"])
def test_teacher_forced_forward_matches_jax(attention):
    jm, params, port = jax_pair(**ATTENTIONS[attention])
    text, lens = _text()
    mel = np.random.RandomState(5).randn(2, 12, 80).astype(np.float32)
    want = jm.forward(params, {"text_input": jnp.asarray(text), "text_lengths": jnp.asarray(lens),
                               "mel_input": jnp.asarray(mel),
                               "mel_lengths": jnp.asarray([12, 8])})
    with torch.no_grad():
        got = port.module(torch.from_numpy(text), torch.from_numpy(lens), torch.from_numpy(mel))
    for key in ("model_outputs", "decoder_outputs", "alignments", "stop_tokens"):
        _close(got[key], want[key], what=key)


@pytest.fixture(scope="module")
def stopping_pair():
    return jax_pair(seed=1, stop=STOP)


def test_inference_matches_jax(stopping_pair, monkeypatch):
    """B = 2, rows stopping at steps 5 and 17 of a 30-step budget: equal
    ``mel_lengths`` and mels within 3e-5 over the whole ``max_steps × r``
    buffer. Divergence: the port leaves after step 24 (the first check of
    the stop flags, every 8 steps, after the last stop) where the JAX scan
    runs all 30, so its ``alignments`` and ``stop_tokens`` hold 24 steps,
    equal to the JAX package's first 24. The output does not depend on
    how often the flags are read."""
    jm, params, port = stopping_pair
    text, lens = _text()
    want = jm.inference(params, jnp.asarray(text), jnp.asarray(lens), max_steps=30)
    probs = jax.nn.sigmoid(np.asarray(want["stop_tokens"]))
    stops = [int(np.argmax(p > 0.5)) for p in probs]
    assert stops == [4, 16] and all(np.abs(p[: s + 1] - 0.5).min() > 1e-3
                                    for p, s in zip(probs, stops))
    with torch.no_grad():
        got = port.inference(torch.from_numpy(text), torch.from_numpy(lens), max_steps=30)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    assert got["mel_lengths"].tolist() == [10, 34]
    for key in ("model_outputs", "decoder_outputs"):
        _close(got[key], want[key], INFERENCE_ATOL, what=key)
    assert got["alignments"].shape[1] == got["stop_tokens"].shape[1] == 24
    _close(got["alignments"], np.asarray(want["alignments"])[:, :24], INFERENCE_ATOL,
           what="alignments")
    _close(got["stop_tokens"], np.asarray(want["stop_tokens"])[:, :24], INFERENCE_ATOL,
           what="stop_tokens")
    for every in (1, 5):
        monkeypatch.setattr(t2_model, "STOP_CHECK_EVERY", every)
        with torch.no_grad():
            other = port.inference(torch.from_numpy(text), torch.from_numpy(lens), max_steps=30)
        assert torch.equal(other["model_outputs"], got["model_outputs"])
        assert torch.equal(other["mel_lengths"], got["mel_lengths"])


def test_synthesis_matches_jax(tmp_path):
    """``synthesis`` of a sentence: ``max(1, budget // r)`` steps, the mel
    cut at ``mel_lengths``, on a tokenizer from the config (graphemes,
    ``english_cleaners``)."""
    text = "Be a voice, not an echo."
    kw = dict(num_chars=None, text_cleaner="english_cleaners", use_phonemes=False)
    jm = JaxTacotron2.init_from_config(small_config(JaxTacotron2Config, **kw))
    params = with_stopnet(unit_gain_convs(drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                         scale=SCALE)),
                          1.0, 0.75)  # stops at step 6 of 192
    port = Tacotron2.init_from_config(small_config(Tacotron2Config, **kw))
    assert port.config.num_chars == jm.config.num_chars
    port.load_state_dict(tacotron2_from_jax_params(params))
    want = jax_synthesis(jm, text, params, use_griffin_lim=False)
    with torch.no_grad():
        got = synthesis(port, text)
    budget = _frame_budget(len(port.tokenizer.text_to_ids(text)))
    assert want["outputs"]["model_outputs"].shape[1] == budget  # (budget // 2) steps of 2
    assert got["outputs"]["model_outputs"].shape[1] == budget
    assert got["model_outputs"].shape == want["model_outputs"].shape
    assert got["model_outputs"].shape[0] == 12
    _close(got["model_outputs"], want["model_outputs"], what="mel")


# ---------------------------------------------------------------------------
# weights: the fidelity fixture, the reference layout, F19, F20
# ---------------------------------------------------------------------------


def test_fidelity_replay_through_the_ports_converter():
    """``tacotron2.npz`` (a reference-layout state at full width, 30
    symbols, softmax location attention; teacher-forced at r = 2 by the
    reference code) through ``load_reference_tacotron2``: mel RMSE under
    ``test_fidelity_corpus``'s bound, and the alignments too."""
    state, ins, outs, meta = _load("tacotron2")
    config = Tacotron2Config(num_chars=meta["num_chars"], r=meta["r"], attention_norm="softmax")
    model = Tacotron2(config)
    model.load_state_dict(load_reference_tacotron2(state, config))
    assert config.norm_type == "folded" and model.r == model.r_init == 2
    text, mel = ins["text"], ins["mel"]
    with torch.no_grad():
        out = model.module(torch.from_numpy(text), torch.full((text.shape[0],), text.shape[1]),
                           torch.from_numpy(mel))
    for key, ref in (("model_outputs", outs["mel"]), ("alignments", outs["alignments"])):
        got = out[key].numpy()
        assert got.shape == ref.shape
        rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
        assert rmse < FIDELITY_RMSE, f"{key} RMSE {rmse}"


@pytest.mark.parametrize("attention", ["location-sigmoid", "dca"])
def test_reference_layout_round_trip(attention):
    """The port's folded state in the reference layout and back, exactly
    (DCA has no ``inputs_layer`` there: it comes back as zeros, which DCA
    never reads); the JAX package's own converter on the same reference
    state gives the port's teacher-forced output; the DDC coarse decoder's
    keys, which only training reads, are dropped."""
    jm, params, port = jax_pair(norm_type="folded", **ATTENTIONS[attention])
    state = port.module.state_dict()
    reference = reference_tacotron2_state(state)
    assert "encoder.convolutions.0.batch_normalization.running_var" in reference
    assert ("decoder.attention.inputs_layer.linear_layer.weight" in reference) == \
        (attention != "dca")
    extra = {"coarse_decoder.linear_projection.linear_layer.weight": np.ones((480, 1536))}
    config = small_config(Tacotron2Config, norm_type="layer", **ATTENTIONS[attention])
    back = load_reference_tacotron2({**reference, **extra}, config)
    assert config.norm_type == "folded" and sorted(back) == sorted(state)
    for key, value in state.items():
        want = torch.zeros_like(value) if attention == "dca" and key == "inputs_layer.weight" \
            else value
        assert torch.equal(back[key], want), key

    jax_module = JaxTacotron2Module(
        num_chars=24, r=2, encoder_in_features=64, decoder_in_features=64, embedding_dim=64,
        query_dim=64, decoder_rnn_dim=64, prenet_dim=32, attn_dim=32, norm_type="folded",
        attn_norm="sigmoid", **({"attn_type": "dynamic_convolution", "location_attn": False}
                                if attention == "dca" else {}))
    jax_params = jax_convert_tacotron2({k: np.asarray(v) for k, v in reference.items()})
    if attention == "dca":  # the JAX converter sizes the unused inputs_layer 128 wide
        jax_params["params"]["inputs_layer"]["kernel"] = np.zeros((64, 32), np.float32)
    text, lens = _text()
    mel = np.random.RandomState(6).randn(2, 8, 80).astype(np.float32)
    want = jax_module.apply(jax_params, jnp.asarray(text), jnp.asarray(lens), jnp.asarray(mel),
                            jnp.asarray([8, 8]))
    loaded = Tacotron2(config)
    loaded.load_state_dict(back)
    with torch.no_grad():
        got = loaded.module(torch.from_numpy(text), torch.from_numpy(lens), torch.from_numpy(mel))
    _close(got["model_outputs"], want["model_outputs"], what="through the reference layout")


def test_f19_prenet_dropout_at_inference():
    """F19: with ``prenet_dropout_at_inference`` the port drops half the
    prenet's units at every step, masks drawn from the generator (seeded 0
    when none is passed), so equal seeds decode equally and other seeds
    not; the JAX package never passes the flag to its prenet and decodes
    as with the flag off."""
    jm, params, port = jax_pair(seed=1, stop=STOP, prenet_dropout_at_inference=True)
    text, lens = _text()
    want = jm.inference(params, jnp.asarray(text), jnp.asarray(lens), max_steps=30)
    jax_off = JaxTacotron2(small_config(JaxTacotron2Config))
    off = jax_off.inference(params, jnp.asarray(text), jnp.asarray(lens), max_steps=30)
    np.testing.assert_array_equal(np.asarray(want["model_outputs"]),
                                  np.asarray(off["model_outputs"]))

    def decode(seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return port.inference(torch.from_numpy(text), torch.from_numpy(lens), max_steps=30,
                                  generator=gen)["decoder_outputs"]

    default, seeded, other = decode(), decode(0), decode(1)
    assert torch.equal(default, seeded) and not torch.equal(default, other)
    assert np.abs(default.numpy() - np.asarray(want["decoder_outputs"])).max() > 1e-2


def test_f20_reduction_factor_from_the_checkpoint(tmp_path):
    """F20: a reference-layout checkpoint trained down from r = 6 to 2 (a
    480-wide projection, ``"r": 2`` beside the weights) under a config that
    still says 6. The port takes ``r_init`` 6 from the projection and ``r``
    2 from the checkpoint, and decodes as the JAX module built with ``r=2,
    r_init=6``; ``synthesis`` budgets 2 frames a step. The JAX package's
    host wrapper takes both from ``config.r``: at 6 it decodes 6 frames a
    step, at 2 its projection is 160 wide and cannot hold the weights."""
    kw = dict(num_chars=24, encoder_in_features=64, decoder_in_features=64, embedding_dim=64,
              query_dim=64, decoder_rnn_dim=64, prenet_dim=32, attn_dim=32, norm_type="folded",
              attn_norm="sigmoid")
    jm = JaxTacotron2Module(r=2, r_init=6, **kw)
    text, lens = _text()
    args = (jnp.asarray(text), jnp.asarray(lens), jnp.zeros((2, 12, 80)), jnp.asarray([12, 12]))
    params = with_stopnet(unit_gain_convs(drawn_params(jm.init, jax.random.PRNGKey(0), *args,
                                                         scale=SCALE)), *STOP)
    assert params["params"]["decoder_cell"]["linear_projection"]["kernel"].shape[1] == 480
    source = Tacotron2(small_config(Tacotron2Config, norm_type="folded"))
    source.load_state_dict(tacotron2_from_jax_params(params))
    reference = reference_tacotron2_state(source.module.state_dict())
    path = tmp_path / "model_file.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in reference.items()}, "r": 2}, path)

    config = small_config(Tacotron2Config, r=6)
    model = Tacotron2(config).load_checkpoint(config, checkpoint_path=str(path), device="cpu")
    assert (model.r_init, model.r, config.r, config.norm_type) == (6, 2, 2, "folded")
    want = jm.apply(params, *args[:2], max_steps=30, method=jm.inference)
    with torch.no_grad():
        got = model.inference(torch.from_numpy(text), torch.from_numpy(lens), max_steps=30)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    _close(got["model_outputs"], want["model_outputs"], what="r 2 of r_init 6")

    class Ids:
        def text_to_ids(self, text, language=None):
            return [1 + ord(c) % 23 for c in text]

    model.tokenizer = Ids()
    with torch.no_grad():
        out = synthesis(model, "hello")
    assert out["outputs"]["model_outputs"].shape[1] == _frame_budget(5)  # 64 steps of 2

    assert JaxTacotron2(small_config(JaxTacotron2Config, r=6)).module.r == 6
    jax_r2 = JaxTacotron2(small_config(JaxTacotron2Config, r=2))
    shapes = jax.eval_shape(jax_r2.init_params, jax.random.PRNGKey(0))
    assert shapes["params"]["decoder_cell"]["linear_projection"]["kernel"].shape[1] == 160


def test_weights_carry_over_strictly():
    """Every leaf of the JAX params lands in the port's state_dict and
    nothing else does: a missing or an extra key raises. The DDC coarse
    decoder's params (``coarse_decoder_cell``) are dropped. A model with GST
    and Capacitron builds, its decoder sized for both style vectors."""
    jm, params, port = jax_pair(double_decoder_consistency=True, ddc_r=3)
    assert "coarse_decoder_cell" in params["params"]
    state = tacotron2_from_jax_params(params)
    assert not any("coarse" in k for k in state)
    assert sorted(state) == sorted(port.module.state_dict())
    missing = dict(state)
    missing.pop("decoder_cell.stopnet.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        Tacotron2(small_config(Tacotron2Config)).load_state_dict(missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        Tacotron2(small_config(Tacotron2Config)).load_state_dict(
            {**state, "decoder_cell.extra": torch.zeros(1)})
    styled = Tacotron2(small_config(Tacotron2Config, use_gst=True, use_capacitron_vae=True,
                                    gst={"gst_embedding_dim": 16}))
    names = styled.module.state_dict()
    assert "gst_layer.style_token_layer.style_tokens" in names
    assert "capacitron_vae_layer.post_mlp.out.weight" in names
    # the cell reads 64 encoder + 16 GST + 128 Capacitron channels
    assert styled.module.inputs_layer.in_features == 64 + 16 + 128


def test_text_lengths_mask_the_location_attention(stopping_pair):
    """Location attention gives padded tokens no weight, so a row decodes
    the same with more padding after it (the B = 4 check of the card run
    relies on it)."""
    _, _, port = stopping_pair
    text, lens = _text()
    wider = np.zeros((2, 32), np.int64)
    wider[:, :16] = text
    with torch.no_grad():
        a = port.inference(torch.from_numpy(text), torch.from_numpy(lens), max_steps=30)
        b = port.inference(torch.from_numpy(wider), torch.from_numpy(lens), max_steps=30)
    assert torch.equal(a["mel_lengths"], b["mel_lengths"])
    _close(b["model_outputs"], a["model_outputs"].numpy(), what="wider padding")
    assert float(b["alignments"][1, :, 9:].abs().max()) == 0.0
