"""The port's Overflow and NeuralHMM (``tts_tpu_torch.models.overflow``, the
Overflow converters of ``utils.convert``) against the JAX package's, on the
CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``: every leaf N(0, 0.3²), norm scales
1 + N(0, 0.3²)), each ``InvConvNear`` weight then orthogonal and each
coupling's ``end`` at a tenth of that scale (a random 4 × 4 weight inverts
to huge values, and random ``end`` layers make the reverse flow amplify
1e-7 differences to 1e-4), the output net's transition column times 4 with
its bias set (``TRANSITION``), carried into the port by
``utils.convert.overflow_from_jax_params``, at tiny widths (32-wide encoder
of 2 states a token, memory 32, prenet 16, output net [32], 16 mels, two
flow blocks of two WaveNet layers). The mel statistics are 0.5 and 2.0, so
the denormalisation shows.

The JAX decode is a jitted ``inference`` scanning ``MAX_FRAMES`` steps;
the port's ``y_lengths`` must equal it, and its frames agree within 1e-5.
The transitions are thresholded at ``duration_threshold``, so each
comparison prints the smallest ``|sigmoid(trans) - threshold|`` over the
decisions taken. With the transition bias at -4 (Overflow) or 1.0
(NeuralHMM, whose draws differ) both rows of the B = 2 batch end early
(``EARLY``); at -4.3 the first row of Overflow never leaves its states and
is cut at the budget, the second ends at the odd length 25.

Divergences from the JAX package, each named in its test:

* the port leaves once every row is done, reading the done flags every
  ``DONE_CHECK_EVERY`` steps, where the JAX scan runs every step; its
  ``model_outputs`` hold the frames that ran (rounded up to a multiple of
  ``num_squeeze`` with the post-flow), equal to the JAX package's first
  frames (``test_sample_and_early_exit_match_jax``);
* F19: ``prenet_dropout_at_inference`` is followed, with masks from a
  seeded ``torch.Generator``; the JAX package never passes it
  (``test_f19_prenet_dropout_at_inference``).

``test_odd_length_frame_of_the_post_flow`` holds F29 as the JAX package
has it: the last frame of an odd length leaves the flow as zero.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import drawn_params

from tts_tpu.models.overflow import NeuralhmmTTS as JaxNeuralhmmTTS
from tts_tpu.models.overflow import NeuralhmmTTSConfig as JaxNeuralhmmTTSConfig
from tts_tpu.models.overflow import Overflow as JaxOverflow
from tts_tpu.models.overflow import OverflowConfig as JaxOverflowConfig
from tts_tpu.models.overflow import model as jax_overflow
from tts_tpu.utils.convert import convert_overflow as jax_convert_overflow
from tts_tpu_torch.models.overflow import NeuralhmmTTS, NeuralhmmTTSConfig, Overflow, \
    OverflowConfig
from tts_tpu_torch.models.overflow import model as hmm_model
from tts_tpu_torch.utils.convert import (
    convert_overflow,
    flax_to_state_dict,
    load_reference_overflow,
    overflow_from_jax_params,
    reference_overflow_state,
)

ATOL = 1e-5
SCALE = 0.3
MAX_FRAMES = 128
TRANSITION = (4.0, -4.0)  # the transition column's scale and bias
# per kind: the transition, then the rows' lengths and the steps that run
# when both rows end early in a MAX_FRAMES budget
EARLY = {"overflow": ((4.0, -4.0), [62, 24], 64), "neuralhmm": ((4.0, 1.0), [35, 17], 40)}
BUDGET_CUT = (4.0, -4.3)  # row 0 never leaves its states, row 1 ends at 25 frames
TINY = dict(num_chars=24, out_channels=16, state_per_phone=2, encoder_in_out_features=32,
            memory_rnn_dim=32, prenet_dim=16, outputnet_size=[32], mel_statistics_mean=0.5,
            mel_statistics_std=2.0)
FLOW = dict(hidden_channels_dec=16, num_flow_blocks_dec=2, num_block_layers=2)
PAIRS = {"overflow": (JaxOverflow, JaxOverflowConfig, Overflow, OverflowConfig),
         "neuralhmm": (JaxNeuralhmmTTS, JaxNeuralhmmTTSConfig, NeuralhmmTTS, NeuralhmmTTSConfig)}


def tiny(kind: str, **kw) -> dict:
    """The tiny config fields of ``kind``; ``kw`` adds or overrides."""
    return TINY | (FLOW if kind == "overflow" else {}) | kw


@functools.lru_cache(maxsize=None)
def jax_model(kind: str):
    """The JAX wrapper of ``kind`` at the tiny widths, its drawn params
    (flows well conditioned, transitions untouched) and its ``inference``
    jitted over the params, so that every test of a kind shares one
    compiled decode."""
    jax_cls, jax_config, _, _ = PAIRS[kind]
    jm = jax_cls(jax_config(**tiny(kind)))
    params = jax.tree_util.tree_map(np.array, drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                           scale=SCALE))
    rs = np.random.RandomState(1)
    for name, leaf in params["params"].get("decoder", {}).items():
        if name.startswith("invconv"):
            s = leaf["weight"].shape[0]
            leaf["weight"] = np.linalg.qr(rs.randn(s, s))[0].astype(np.float32)
        if name.startswith("coupling"):
            leaf["end"] = {k: v * 0.1 for k, v in leaf["end"].items()}
    return jm, params, jax.jit(jm.inference, static_argnames=("max_frames",))


def with_transition(params, weight_scale: float, bias: float):
    """Numpy params with the output net's transition column scaled and its
    bias set."""
    params = jax.tree_util.tree_map(np.array, params)
    proj = params["params"]["neural_hmm"]["output_net"]["proj"]
    proj["kernel"][:, -1] *= weight_scale
    proj["bias"][-1] = bias
    return params


def pair(kind="overflow", transition=TRANSITION, **kw):
    """``(jitted JAX inference, params, port wrapper)`` of ``kind`` with the
    transition set; ``kw`` overrides the port's config."""
    jm, params, infer = jax_model(kind)
    params = with_transition(params, *transition)
    port = PAIRS[kind][2](PAIRS[kind][3](**tiny(kind, **kw)))
    port.load_state_dict(overflow_from_jax_params(params))
    return infer, params, port


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
    return err


def decision_margin(out, threshold: float) -> float:
    """Smallest ``|p_move - threshold|`` over the decisions a decode took:
    every step of a row up to and including the one that left its last
    state."""
    p = out["transitions"].numpy()
    steps = p.shape[1]
    return min(float(np.abs(p[b, : min(int(n) + 1, steps)] - threshold).min())
               for b, n in enumerate(out["y_lengths"]))


def decode_both(infer, params, port, max_frames=MAX_FRAMES):
    text, lens = _text()
    want = infer(params, jnp.asarray(text), jnp.asarray(lens), max_frames=max_frames)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(text), torch.from_numpy(lens),
                             max_frames=max_frames)
    return got, {k: np.asarray(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_encoder_on_a_padded_batch_matches_jax():
    """Two rows of unequal length in one padded batch: the backward LSTM
    starts at each row's true end (the packed ``nn.LSTM`` against the JAX
    encoder's ``seq_lengths``), and the ``[B, T, 2·half·spp]`` output is
    read as ``spp`` states a token in the same order. The JAX encoder's
    states of padded tokens are never read (the sampler stays below
    ``state_lengths``); the port's are zeros."""
    jm = jax_overflow.OverflowEncoder(num_chars=24, state_per_phone=2, in_out_channels=32)
    text, lens = _text(3)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(lens),
                          scale=SCALE)
    port = hmm_model.OverflowEncoder(24, 2, 32)
    port.load_state_dict(overflow_from_jax_params(params), strict=True)
    want, want_lengths = jm.apply(params, jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        got, lengths = port(torch.from_numpy(text), torch.from_numpy(lens))
    assert lengths.tolist() == np.asarray(want_lengths).tolist() == [32, 18]
    _close(got[0], np.asarray(want)[0], what="row 0")
    _close(got[1, :18], np.asarray(want)[1, :18], what="row 1, valid states")
    assert torch.all(got[1, 18:] == 0)
    # the backward direction is the second state of each token
    with torch.no_grad():
        mask = torch.from_numpy(np.arange(16)[None, :, None] < lens[:, None, None]).float()
        h = port.emb(torch.from_numpy(text))
        for conv in (port.conv_0, port.conv_1, port.conv_2):
            h = conv(h * mask)
        plain = port.lstm(h * mask)[0]
    assert (plain[1, :9, 32:] - got[1, 1:18:2]).abs().max() > 1e-3


def test_outputnet_matches_jax():
    """The JAX output net runs on every state and the sampler picks one;
    the port's runs on each row's current state: every (row, state) pair,
    as one row each, against the JAX package's outputs."""
    jm = jax_overflow.Outputnet(frame_channels=16, outputnet_size=(32, 24), std_floor=0.001)
    rs = np.random.RandomState(4)
    memory = rs.randn(2, 32).astype(np.float32)
    states = rs.randn(2, 7, 20).astype(np.float32)
    params = drawn_params(jm.init, jax.random.PRNGKey(0), jnp.asarray(memory),
                          jnp.asarray(states), scale=SCALE)
    port = hmm_model.Outputnet(32, 20, 16, (32, 24), 0.001)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    want = jm.apply(params, jnp.asarray(memory), jnp.asarray(states))
    with torch.no_grad():
        got = port(torch.from_numpy(np.repeat(memory, 7, axis=0)),
                   torch.from_numpy(states.reshape(14, 20)))
    for name, g, w in zip(("mean", "std", "transition"), got, want):
        _close(g, np.asarray(w).reshape(14, *np.asarray(w).shape[2:]), what=name)
    assert float(got[1].min()) >= 0.001


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["overflow", "neuralhmm"])
def test_sample_and_early_exit_match_jax(kind, monkeypatch):
    """B = 2, both rows ending early (Overflow: 62 and 24 frames for 32 and
    18 states; NeuralHMM: 35 and 17) in a 128-frame budget: equal
    ``y_lengths``, the frames that ran within 1e-5 of the JAX package's
    first frames (after them the JAX package holds
    ``mel_statistics_mean``), and the decode leaves at the first read of
    the done flags after the last row's end where the JAX scan runs all
    128. How often the flags are read changes no output."""
    transition, lengths, steps = EARLY[kind]
    infer, params, port = pair(kind, transition)
    got, want = decode_both(infer, params, port)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), want["y_lengths"])
    assert got["y_lengths"].tolist() == lengths
    assert got["transitions"].shape[1] == steps == got["model_outputs"].shape[1]
    err = _close(got["model_outputs"], want["model_outputs"][:, :steps], what=kind)
    assert np.all(want["model_outputs"][:, steps:] == 0.5)
    margin = decision_margin(got, port.config.duration_threshold)
    print(f"{kind}: y_lengths {lengths}, max abs diff {err:.3g}, smallest "
          f"|p_move - threshold| over the decisions {margin:.3g}")
    assert margin > 1e-4
    for every in (1, 5):
        monkeypatch.setattr(hmm_model, "DONE_CHECK_EVERY", every)
        with torch.no_grad():
            other = port.inference(*map(torch.from_numpy, _text()), max_frames=MAX_FRAMES)
        n = max(lengths)
        assert torch.equal(other["y_lengths"], got["y_lengths"])
        assert other["model_outputs"].shape[1] >= n
        assert torch.equal(other["model_outputs"][:, :n], got["model_outputs"][:, :n])


@pytest.fixture(scope="module")
def budget_cut():
    infer, params, port = pair("overflow", BUDGET_CUT)
    return decode_both(infer, params, port), port


def test_budget_cut_matches_jax(budget_cut):
    """A row whose transitions stop firing is cut at the budget (128
    frames), and the early exit does not end its decode sooner; the other
    row ends at 25 as in the JAX package."""
    (got, want), port = budget_cut
    np.testing.assert_array_equal(got["y_lengths"].numpy(), want["y_lengths"])
    assert got["y_lengths"].tolist() == [MAX_FRAMES, 25]
    assert got["transitions"].shape[1] == MAX_FRAMES
    err = _close(got["model_outputs"], want["model_outputs"], what="budget cut")
    margin = decision_margin(got, port.config.duration_threshold)
    print(f"budget cut: max abs diff {err:.3g}, smallest |p_move - threshold| {margin:.3g}")
    assert margin > 1e-4


def test_odd_length_frame_of_the_post_flow(budget_cut):
    """F29 as the JAX package has it: ``squeeze`` takes each pair's mask
    from its second frame, so the last valid frame of the odd length 25
    leaves the flow as zero and is ``mel_statistics_mean`` after the
    denormalisation, in both packages, while frame 23 is not; the port
    runs the flow on 26 frames, the JAX package on 128."""
    (got, want), _ = budget_cut
    row, last = got["model_outputs"][1].numpy(), want["model_outputs"][1]
    assert np.all(row[24] == 0.5) and np.all(last[24] == 0.5)
    assert np.abs(row[23] - 0.5).max() > 0.1
    _close(row[:25], last[:25], what="row 1")


def test_f19_prenet_dropout_at_inference():
    """F19: with ``prenet_dropout_at_inference`` the port drops half the
    prenet's units at every step, masks drawn from the generator (seeded 0
    when none is passed), so equal seeds decode equally and other seeds
    not; the JAX ``sample`` calls its prenet with ``train=False`` and never
    reads the flag, so it decodes as with the flag off."""
    infer, params, port = pair("neuralhmm", prenet_dropout_at_inference=True)
    text, lens = map(torch.from_numpy, _text())
    jax_config = JaxNeuralhmmTTSConfig(**tiny("neuralhmm", prenet_dropout_at_inference=True))
    jm_on = JaxNeuralhmmTTS(jax_config)
    want = jm_on.inference(params, jnp.asarray(text.numpy()), jnp.asarray(lens.numpy()),
                           max_frames=32)
    off = infer(params, jnp.asarray(text.numpy()), jnp.asarray(lens.numpy()), max_frames=32)
    np.testing.assert_array_equal(np.asarray(want["model_outputs"]),
                                  np.asarray(off["model_outputs"]))

    def decode(seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return port.inference(text, lens, max_frames=32, generator=gen)["model_outputs"]

    default, seeded, other = decode(), decode(0), decode(1)
    assert torch.equal(default, seeded) and not torch.equal(default, other)
    n = default.shape[1]
    assert np.abs(default.numpy() - np.asarray(want["model_outputs"])[:, :n]).max() > 1e-2


def test_sampling_draws_from_the_generator():
    """A sampling temperature above 0 and stochastic transitions (neither
    is the JAX wrapper's default, which every parity test keeps) draw from
    the generator: equal seeds decode equally, other seeds not."""
    _, _, port = pair("overflow", deterministic_transition=False)
    text, lens = map(torch.from_numpy, _text())

    def decode(seed, temp):
        with torch.no_grad():
            return port.inference(text, lens, max_frames=48, sampling_temp=temp,
                                  generator=torch.Generator().manual_seed(seed))

    for temp in (0.0, 0.6):
        a, b, c = decode(0, temp), decode(0, temp), decode(1, temp)
        assert torch.equal(a["model_outputs"], b["model_outputs"])
        assert torch.equal(a["y_lengths"], b["y_lengths"])
        assert not torch.equal(a["transitions"][:, :8], c["transitions"][:, :8])


# ---------------------------------------------------------------------------
# weights: the reference layout, strict carry-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["overflow", "neuralhmm"])
def test_reference_layout_round_trip(kind, tmp_path):
    """The port's folded state in the reference layout with ``mean`` and
    ``std`` and back, exactly; ``load_reference_overflow`` sets
    ``norm_type`` and the mel statistics as the JAX zoo conversion does,
    and the JAX package's own converter reads the same reference state
    into the same leaves as the port's copy; a reference checkpoint file
    loads through ``load_checkpoint`` and decodes as the state it came
    from."""
    cls, config_cls = PAIRS[kind][2:]
    source = cls(config_cls(**tiny(kind, norm_type="folded")))
    source.init_params(seed=3, device="cpu")
    state = source.module.state_dict()
    reference = reference_overflow_state(state, mean=-4.25, std=1.5)
    assert "encoder.convolutions.0.batch_normalization.running_var" in reference
    assert ("decoder.glow_decoder.flows.4.weight" in reference) == (kind == "overflow")
    assert not any(k.startswith("neural_hmm.prenet.") and k.endswith("bias") for k in reference)
    config = config_cls(**tiny(kind))
    back = load_reference_overflow(dict(reference), config)
    assert (config.norm_type, config.mel_statistics_mean, config.mel_statistics_std) == \
        ("folded", -4.25, 1.5)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    ours = jax.tree_util.tree_leaves_with_path(convert_overflow(dict(reference), config))
    theirs = dict(jax.tree_util.tree_leaves_with_path(
        jax_convert_overflow(dict(reference), config)))
    assert len(ours) == len(theirs) > 20
    for path, leaf in ours:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(theirs[path]))

    path = tmp_path / "model_file.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in reference.items()}},
               path)
    config = config_cls(**tiny(kind))
    loaded = cls(config).load_checkpoint(config, checkpoint_path=str(path), device="cpu")
    source.config.mel_statistics_mean, source.config.mel_statistics_std = -4.25, 1.5
    text, lens = map(torch.from_numpy, _text())
    with torch.no_grad():
        a = loaded.inference(text, lens, max_frames=24)
        b = source.inference(text, lens, max_frames=24)
    assert torch.equal(a["model_outputs"], b["model_outputs"])


def test_weights_carry_over_strictly():
    """Every leaf of the JAX params lands in the port's state_dict and
    nothing else does: a missing or an extra key raises; a prenet bias the
    reference layout cannot hold raises there."""
    _, params, _ = jax_model("overflow")
    state = overflow_from_jax_params(params)
    port = Overflow(OverflowConfig(**tiny("overflow")))
    assert sorted(state) == sorted(port.module.state_dict())
    assert "neural_hmm.memory_rnn.weight_hh" in state and "encoder.lstm.weight_ih_l0_reverse" \
        in state
    missing = dict(state)
    missing.pop("neural_hmm.output_net.proj.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        Overflow(OverflowConfig(**tiny("overflow"))).load_state_dict(missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        Overflow(OverflowConfig(**tiny("overflow"))).load_state_dict(
            {**state, "decoder.extra": torch.zeros(1)})
    folded = Overflow(OverflowConfig(**tiny("overflow", norm_type="folded")))
    folded.init_params(seed=0, device="cpu")
    with torch.no_grad():
        folded.module.neural_hmm.prenet.linear_0.bias.fill_(0.1)
    with pytest.raises(ValueError, match="no bias"):
        reference_overflow_state(folded.module.state_dict())
