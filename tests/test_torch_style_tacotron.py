"""The port's style layers and Tacotron v1 (``tts_tpu_torch.layers.tacotron_v1``,
``layers.capacitron``, the style branch of ``models.tacotron2.model``,
``models.tacotron2.tacotron_v1`` and their converters in ``utils.convert``)
against the JAX package's, on the CPU, at tolerance 1e-5.

The same weights go into both packages: flax parameters at unit gain
(:func:`unit_gain`: kernels N(0, 1/fan_in), folded norm scales
1 + N(0, 0.1²), style tokens N(0, 0.5²), other leaves N(0, 0.1²)), so that
the six stride-2 convolutions of a reference encoder neither vanish nor
blow up, carried into the port by ``gst_from_jax_params``,
``capacitron_from_jax_params``, ``tacotron2_from_jax_params`` and
``tacotron_from_jax_params``. The free-running decodes never stop (stopnet
weight 0, bias −10) and run 10 steps of r = 2.

Capacitron's standard normal draw cannot be shared by key (a
``torch.Generator`` cannot replay ``jax.random``): :func:`with_draw` takes
it out of the JAX run, as ``(z − mu) / √(var + 1e-6)`` of the posterior or
as ``z`` itself for the prior, by applying the JAX model's ``_encode`` under
the same noise key as its decode, and hands it to the port as ``eps``. The
JAX models run jitted, one compile per case (eager flax dispatches op by
op, a few seconds a call on the CPU).

Divergences from the JAX package, each named in its test:

* F39: the JAX ``Tacotron`` wrapper (Tacotron v1) inherits
  ``Tacotron2.inference``, which passes its module no ``style_mel``, so a
  style mel in ``aux_input`` changes nothing there; the port's reads it
  (``test_f39_tacotron_v1_reads_the_style_mel``);
* F41 (kept): Tacotron v1 is the JAX package's network, not the
  reference's, and loads only the port's own checkpoint
  (``test_tacotron_v1_weights_carry_over_strictly``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tacotron2 import small_config, with_stopnet

from tts_tpu.layers import capacitron as jax_capacitron
from tts_tpu.layers import tacotron_v1 as jax_v1
from tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tts_tpu.models.tacotron2 import Tacotron2Config as JaxTacotron2Config
from tts_tpu.models.tacotron2.config import TacotronConfig as JaxTacotronConfig
from tts_tpu.models.tacotron2.tacotron_v1 import Tacotron as JaxTacotron
from tts_tpu.utils.convert import convert_capacitron as jax_convert_capacitron
from tts_tpu.utils.convert import convert_gst as jax_convert_gst
from tts_tpu_torch.layers import capacitron, tacotron_v1
from tts_tpu_torch.models import config_from_dict, setup_model
from tts_tpu_torch.models.tacotron2 import Tacotron, Tacotron2, Tacotron2Config, TacotronConfig
from tts_tpu_torch.utils.convert import (
    capacitron_from_jax_params,
    convert_capacitron,
    convert_gst,
    gst_from_jax_params,
    load_reference_tacotron2,
    reference_tacotron2_state,
    tacotron2_from_jax_params,
    tacotron_from_jax_params,
)

ATOL = 1e-5
STEPS = 10
NEVER_STOP = (0.0, -10.0)
INFER_RNGS = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(7)}  # JAX wrapper's
FORWARD_RNGS = {"dropout": jax.random.PRNGKey(0),
                "noise": jax.random.fold_in(jax.random.PRNGKey(0), 2)}
GST = {"gst_embedding_dim": 32, "gst_num_heads": 2, "gst_num_style_tokens": 5}
CAPACITRON = {"capacitron_VAE_embedding_dim": 8}
STYLES = {"gst": dict(use_gst=True, gst=GST),
          "capacitron": dict(use_capacitron_vae=True, capacitron_vae=CAPACITRON,
                             norm_type="folded")}


def unit_gain(tree, seed=0):
    """Numpy leaves of ``tree``'s structure (arrays or shapes): kernels
    N(0, 1/fan_in), norm scales (``scale``, a folded ``scale_i``)
    1 + N(0, 0.1²), style tokens N(0, 0.5²), everything else N(0, 0.1²)."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return (rs.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1])))\
                .astype(np.float32)
        draw = rs.standard_normal(leaf.shape) * (0.5 if name == "style_tokens" else 0.1)
        return (draw + 1 if name.startswith("scale") else draw).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"


def _mel(T=29, M=16, seed=3, B=2):
    return np.random.RandomState(seed).randn(B, T, M).astype(np.float32)


def _text(seed=0):
    """Two rows of 16 ids, the second padded after 9."""
    rs = np.random.RandomState(seed)
    return rs.randint(1, 24, (2, 16)), np.array([16, 9])


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["layer", "folded"])
def test_gst_layers_match_jax(norm_type):
    """``ReferenceEncoder`` (six 3x3 stride-2 convolutions, the
    channel-major flatten, the GRU's last step), ``StyleTokenLayer`` and
    the whole ``GST``, on a 29-frame mel of 16 bins."""
    mel = _mel()
    jm = jax_v1.GST(num_mel=16, num_heads=2, num_style_tokens=5, gst_embedding_dim=32,
                    norm_type=norm_type)
    params = unit_gain(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(mel)))
    port = tacotron_v1.GST(16, 2, 5, 32, norm_type)
    port.load_state_dict(gst_from_jax_params(params), strict=True)
    inner = params["params"]
    query = jax_v1.ReferenceEncoder(32, norm_type).apply({"params": inner["encoder"]},
                                                         jnp.asarray(mel))
    style = jax_v1.StyleTokenLayer(2, 5, 32).apply({"params": inner["style_token_layer"]}, query)
    with torch.no_grad():
        got_query = port.encoder(_t(mel))
        _close(got_query, query, what="reference encoder")
        _close(port.style_token_layer(got_query), style, what="style tokens")
        _close(port(_t(mel)), jm.apply(params, jnp.asarray(mel)), what="GST")
    assert np.abs(np.asarray(style)).max() > 0.05


def _jax_vae():
    return jax_capacitron.CapacitronVAE(capacitron_VAE_embedding_dim=8,
                                        reference_encoder_out_dim=12,
                                        text_summary_embedding_dim=6, norm_type="folded")


def test_capacitron_posterior_and_draws_match_jax():
    """The posterior's mean and variance at ragged mel and text lengths
    against ``CapacitronVAE.posterior_stats``; ``z`` of the posterior given
    the JAX draw; the prior's ``z`` is the draw itself."""
    rs = np.random.RandomState(1)
    mel, mel_lengths = _mel(T=37), np.array([37, 22])
    mel[1, 22:] = 0  # zero-padded, as a batch of mels is
    text, text_lengths = rs.randn(2, 9, 10).astype(np.float32), np.array([9, 5])
    jm = _jax_vae()
    args = [jnp.asarray(a) for a in (mel, text, text_lengths, mel_lengths)]
    params = unit_gain(jax.eval_shape(
        lambda k: jm.init({"params": k, "noise": k}, *args), jax.random.PRNGKey(0)))
    port = capacitron.CapacitronVAE(16, 10, 8, 12, 6, "folded")
    port.load_state_dict(capacitron_from_jax_params(params), strict=True)
    mu, var = jm.apply(params, *[jnp.asarray(a) for a in (mel, mel_lengths, text, text_lengths)],
                       method=jm.posterior_stats)
    rngs = {"noise": jax.random.PRNGKey(5)}
    z = np.asarray(jm.apply(params, *args, rngs=rngs)[0][:, 0])
    prior = np.asarray(jm.apply(params, None, args[1], args[2], rngs=rngs)[0][:, 0])
    eps = (z - np.asarray(mu)) / np.sqrt(np.asarray(var) + 1e-6)
    with torch.no_grad():
        got_mu, got_var = port.posterior_stats(_t(mel), _t(mel_lengths), _t(text),
                                               _t(text_lengths))
        _close(got_mu, mu, what="mu")
        _close(got_var, var, what="variance")
        _close(port(_t(mel), _t(text), _t(text_lengths), _t(mel_lengths), eps=_t(eps)), z,
               what="posterior z")
        _close(port(None, _t(text), eps=_t(prior)), prior, what="prior z")
        # a shorter row reads its own last valid step: padding changes nothing
        short = port.posterior_stats(_t(mel[1:, :22]), _t(mel_lengths[1:]),
                                     _t(text[1:, :5]), _t(text_lengths[1:]))
    _close(short[0], np.asarray(mu)[1:], what="row 2 alone")
    assert float(np.asarray(var).min()) > 0


def test_capacitron_draws_from_its_generator_on_the_host():
    """Without ``eps`` the prior is drawn by ``capacitron.normal`` on the
    host from the caller's generator: the same seed gives the same ``z``."""
    port = capacitron.CapacitronVAE(16, 10, 8, 12, 6)
    text = torch.zeros(2, 5, 10)
    a = port(None, text, generator=torch.Generator().manual_seed(3))
    b = port(None, text, generator=torch.Generator().manual_seed(3))
    assert a.shape == (2, 8) and torch.equal(a, b)
    assert torch.equal(a, torch.randn((2, 8), generator=torch.Generator().manual_seed(3)))


def test_cbhg_matches_jax_and_ignores_padding():
    """The CBHG under a frame mask (conv bank of kernels 1..4, −1e9 before
    the max-pool, re-zeroed projections, highways, a biGRU over each row's
    valid frames) against the JAX CBHG at the valid positions; a row decoded
    alone, without the padding, gives the same frames."""
    x = np.random.RandomState(2).randn(2, 12, 6).astype(np.float32)
    lengths = np.array([12, 7])
    mask = (np.arange(12)[None, :] < lengths[:, None])[:, :, None].astype(np.float32)
    jm = jax_v1.CBHG(K=4, conv_bank_features=8, conv_projections=(8, 6), highway_features=8,
                     gru_features=8)
    params = unit_gain(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                      x_mask=jnp.asarray(mask)))
    port = tacotron_v1.CBHG(6, K=4, conv_bank_features=8, conv_projections=(8, 6),
                            highway_features=8, gru_features=8)
    port.load_state_dict(tacotron_from_jax_params(params), strict=True)
    want = np.asarray(jm.apply(params, jnp.asarray(x), x_mask=jnp.asarray(mask))) * mask
    with torch.no_grad():
        got = port(_t(x), _t(mask))
        alone = port(_t(x[1:, :7]), _t(mask[1:, :7]))
    _close(got * _t(mask), want, what="CBHG")
    _close(alone, want[1:, :7], what="row 2 without its padding")
    assert torch.all(got[1, 7:] == 0)


def test_style_converters_match_jax_leaf_for_leaf():
    """A reference-layout GST and Capacitron (``reference_tacotron2_state``
    of a folded Tacotron2 with both) through both packages'
    ``convert_gst`` and ``convert_capacitron``; ``load_reference_tacotron2``
    maps the file back to the port's state exactly."""
    config = small_config(Tacotron2Config, **STYLES["gst"], **STYLES["capacitron"])
    jm = JaxTacotron2(small_config(JaxTacotron2Config, **STYLES["gst"], **STYLES["capacitron"]))
    params = unit_gain(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    state = tacotron2_from_jax_params(params)
    reference = reference_tacotron2_state(state)
    assert "gst_layer.encoder.bns.5.running_var" in reference
    assert "capacitron_vae_layer.post_encoder_mlp.net.2.weight" in reference
    for port_fn, jax_fn, prefix in ((convert_gst, jax_convert_gst, "gst_layer."),
                                    (convert_capacitron, jax_convert_capacitron,
                                     "capacitron_vae_layer.")):
        got = jax.tree_util.tree_leaves_with_path(port_fn(dict(reference), prefix))
        want = dict(jax.tree_util.tree_leaves_with_path(jax_fn(dict(reference), prefix)))
        assert len(got) == len(want) > 20
        for path, leaf in got:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(want[path]),
                                          err_msg=str(path))
    back = load_reference_tacotron2(reference, config)
    assert config.norm_type == "folded" and sorted(back) == sorted(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)


# ---------------------------------------------------------------------------
# Tacotron2 with GST or Capacitron
# ---------------------------------------------------------------------------


def style_pair(style, seed=0):
    """A JAX ``Tacotron2`` with the ``style`` of :data:`STYLES`, its params
    at unit gain (never stopping) and the port's ``Tacotron2`` carrying
    them."""
    kw = STYLES[style]
    jm = JaxTacotron2(small_config(JaxTacotron2Config, out_channels=16, **kw))
    params = with_stopnet(unit_gain(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                                    seed), *NEVER_STOP)
    port = Tacotron2(small_config(Tacotron2Config, out_channels=16, **kw))
    port.load_state_dict(tacotron2_from_jax_params(params))
    return jm, params, port


@pytest.fixture(scope="module", params=list(STYLES))
def pair(request):
    return request.param, style_pair(request.param)


def with_draw(module, apply, run, encode, posterior):
    """``apply(run)`` of the JAX ``module``, and the JAX Capacitron's
    standard normal draw in it: ``apply(encode)``, the model's ``_encode``
    under the same noise key (a separate ``apply``, so that the key is
    derived as in the run), gives ``z`` in the encoder outputs' last columns;
    ``posterior(m, enc)`` the posterior's mean and variance on the outputs
    before ``z`` (``None`` for the prior). The draw is ``(z − mu) / √(var +
    1e-6)``, or ``z`` itself. The caller jits it all as one function."""
    out = apply(run)
    if not module.use_capacitron_vae:
        return out, None
    enc = apply(encode)[0]
    D = module.capacitron_VAE_embedding_dim
    z = enc[:, 0, -D:]
    stats = apply(lambda m: posterior(m, enc[:, :, :-D]))
    if stats is None:
        return out, z
    mu, var = stats
    return out, (z - mu) / jnp.sqrt(var + 1e-6)


def jax_t2(jm, params, rngs, text, lens, style_mel, mel_lengths=None, forward=False):
    """The JAX Tacotron2 module's teacher-forced forward over ``style_mel``
    (``forward``) or free-running decode styled by ``style_mel``, with its
    Capacitron draw (:func:`with_draw`), in one jitted call."""
    def fn(p, x, xl, mel, ml):
        if forward:
            run = lambda m: m(x, xl, mel, ml, train=False)  # noqa: E731
        else:
            run = lambda m: m.inference(  # noqa: E731
                x, xl, None if mel is None else {"style_mel": mel}, max_steps=STEPS)
        return with_draw(
            jm.module, lambda f: jm.module.apply(p, method=f, rngs=rngs), run,
            lambda m: m._encode(x, xl, None, False, mel, ml),
            lambda m, enc: None if mel is None else m.capacitron_layer.posterior_stats(
                mel, ml, enc, xl))

    out, eps = jax.jit(fn)(params, jnp.asarray(text), jnp.asarray(lens), _j(style_mel),
                           _j(mel_lengths))
    return out, None if eps is None else np.asarray(eps)


def test_tacotron2_style_teacher_forced_matches_jax(pair):
    """The teacher-forced forward takes its style from the target mel
    itself (Capacitron within ``mel_lengths``): mels, stop tokens and
    alignments within 1e-5."""
    style, (jm, params, port) = pair
    text, lens = _text()
    mel, mel_lengths = _mel(T=12), np.array([12, 8])
    want, eps = jax_t2(jm, params, FORWARD_RNGS, text, lens, mel, mel_lengths, forward=True)
    with torch.no_grad():
        got = port.module(_t(text), _t(lens), _t(mel), mel_lengths=_t(mel_lengths), eps=_t(eps))
    for key in ("model_outputs", "decoder_outputs", "alignments", "stop_tokens"):
        _close(got[key], want[key], what=key)


@pytest.mark.parametrize("with_style", [True, False], ids=["style_mel", "no_style"])
def test_tacotron2_style_free_running_matches_jax(pair, with_style):
    """The free-running decode with a style mel (GST's style vector;
    Capacitron's posterior) and without (GST's zeros; Capacitron's prior),
    the draw taken out of the JAX run: ``mel_lengths`` equal, mels within
    1e-5, and a style mel changes the output."""
    style, (jm, params, port) = pair
    text, lens = _text()
    style_mel = _mel(T=23) if with_style else None
    want, eps = jax_t2(jm, params, INFER_RNGS, text, lens, style_mel)
    with torch.no_grad():
        got = port.inference(_t(text), _t(lens), max_steps=STEPS,
                             aux_input={"style_mel": _t(style_mel)} if with_style else None,
                             eps=_t(eps))
        other = port.inference(_t(text), _t(lens), max_steps=STEPS,
                               aux_input={"style_mel": _t(_mel(T=23, seed=9))}, eps=_t(eps))
    assert torch.equal(got["mel_lengths"], torch.from_numpy(np.asarray(want["mel_lengths"])))
    _close(got["model_outputs"], want["model_outputs"], what="model_outputs")
    _close(got["alignments"], want["alignments"], what="alignments")
    assert float((other["model_outputs"] - got["model_outputs"]).abs().max()) > 1e-3


def test_tacotron2_capacitron_wrapper_draws_the_same_on_each_call():
    """Without ``eps`` the wrapper draws Capacitron's prior from a host
    generator seeded 0 at each call, as the JAX wrapper keys each call with
    one noise key: two calls agree, and equal the module handed that draw."""
    port = Tacotron2(small_config(Tacotron2Config, out_channels=16, **STYLES["capacitron"]))
    port.init_params(seed=2, device="cpu")
    text, lens = _text()
    with torch.no_grad():
        a = port.inference(_t(text), _t(lens), max_steps=4)
        b = port.inference(_t(text), _t(lens), max_steps=4)
        eps = capacitron.normal((2, 8), torch.Generator().manual_seed(0))
        c = port.module.inference(_t(text), _t(lens), max_steps=4, eps=eps)
    assert torch.equal(a["model_outputs"], b["model_outputs"])
    assert torch.equal(a["model_outputs"], c["model_outputs"])


# ---------------------------------------------------------------------------
# Tacotron v1
# ---------------------------------------------------------------------------

V1 = dict(num_chars=24, r=2, decoder_output_dim=16, out_channels=33, embedding_dim=32,
          cbhg_K=4, post_cbhg_K=3, cbhg_features=16, query_dim=32, decoder_rnn_dim=32,
          prenet_dim=16, attn_dim=16, max_decoder_steps=STEPS)
V1_STYLES = {"plain": {}, "gst": {"use_gst": True},
             "capacitron": {"use_capacitron_vae": True}}
V1_RNGS = {"dropout": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}


def jax_v1_run(jm, params, text, lens, style_mel):
    """The JAX ``TacotronModule.inference`` called with ``style_mel=``, with
    its Capacitron draw, in one jitted call."""
    def fn(p, x, xl, mel):
        return with_draw(
            jm.module, lambda f: jm.module.apply(p, method=f, rngs=V1_RNGS),
            lambda m: m.inference(x, xl, max_steps=STEPS, style_mel=mel),
            lambda m: m._encode(x, xl, mel, False),
            lambda m, enc: None if mel is None else m.capacitron_layer.posterior_stats(
                mel, None, enc))

    out, eps = jax.jit(fn)(params, jnp.asarray(text), jnp.asarray(lens), _j(style_mel))
    return out, None if eps is None else np.asarray(eps)


@functools.lru_cache(maxsize=None)
def v1_case(kind):
    """A JAX Tacotron v1 of :data:`V1` with the style ``kind`` of
    ``V1_STYLES``, its params at unit gain (never stopping), the port
    carrying them, and the JAX module's decode of :func:`_text` styled by a
    21-frame mel (none for ``plain``) with its draw; built once a process."""
    kw = dict(V1, **V1_STYLES[kind])
    jm = JaxTacotron(JaxTacotronConfig(**kw))
    params = with_stopnet(unit_gain(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))),
                          *NEVER_STOP)
    port = Tacotron(TacotronConfig(**kw))
    port.load_state_dict(tacotron_from_jax_params(params))
    style_mel = None if kind == "plain" else _mel(T=21)
    return jm, params, port, style_mel, jax_v1_run(jm, params, *_text(), style_mel)


@pytest.mark.parametrize("kind", list(V1_STYLES))
def test_tacotron_v1_matches_the_jax_module(kind):
    """The free-running decode against the JAX ``TacotronModule.inference``
    called with ``style_mel=``: the linear spectrogram (post-CBHG under the
    stop mask) and the mel within 1e-5."""
    jm, params, port, style_mel, (want, eps) = v1_case(kind)
    text, lens = _text()
    with torch.no_grad():
        got = port.inference(_t(text), _t(lens), max_steps=STEPS, eps=_t(eps),
                             aux_input=None if style_mel is None else {"style_mel":
                                                                       _t(style_mel)})
    assert torch.equal(got["mel_lengths"], torch.from_numpy(np.asarray(want["mel_lengths"])))
    assert got["model_outputs"].shape == (2, STEPS * 2, 33)
    _close(got["model_outputs"], want["model_outputs"], what="linear")
    _close(got["decoder_outputs"], want["decoder_outputs"], what="mel")
    assert float(np.abs(np.asarray(want["model_outputs"])).max()) > 0.1


def test_f39_tacotron_v1_reads_the_style_mel():
    """F39: through the JAX ``Tacotron`` wrapper (``Tacotron2.inference``) a
    style mel in ``aux_input`` is never passed to the module, so a GST
    Tacotron v1 decodes with the zero style, as the port does without a
    style mel; the port's wrapper reads ``aux_input["style_mel"]`` and
    equals the JAX module called with ``style_mel=``."""
    jm, params, port, style_mel, (styled, _) = v1_case("gst")
    text, lens = _text()
    via_wrapper = jax.jit(lambda p, x, xl, a: jm.inference(p, x, xl, aux_input=a,
                                                           max_steps=STEPS))(
        params, jnp.asarray(text), jnp.asarray(lens), {"style_mel": jnp.asarray(style_mel)})
    with torch.no_grad():
        neutral = port.inference(_t(text), _t(lens), max_steps=STEPS)
        got = port.inference(_t(text), _t(lens), max_steps=STEPS,
                             aux_input={"style_mel": _t(style_mel)})
    _close(neutral["model_outputs"], via_wrapper["model_outputs"], what="the JAX wrapper")
    _close(got["model_outputs"], styled["model_outputs"], what="port vs module with style_mel")
    assert float((got["model_outputs"] - neutral["model_outputs"]).abs().max()) > 1e-3


def test_tacotron_v1_weights_carry_over_strictly(tmp_path):
    """Every leaf of the JAX v1 params lands in the port's state_dict
    (each CBHG's two ``GRUCell``s in one bidirectional ``gru``), a missing
    key raises, ``tacotron`` is in the registry, the port's own
    ``model_torch.pt`` loads (with its ``r``), and a reference-layout file
    raises naming F41."""
    jm, params, port, _, _ = v1_case("capacitron")
    state = tacotron_from_jax_params(params)
    assert sorted(state) == sorted(port.module.state_dict())
    assert "post_cbhg.gru.weight_hh_l0_reverse" in state
    missing = dict(state)
    missing.pop("last_linear.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        Tacotron(TacotronConfig(**V1, use_capacitron_vae=True)).load_state_dict(missing)
    config = config_from_dict(TacotronConfig(**dict(V1, num_chars=None)).to_dict())
    with torch.device("meta"):
        model = setup_model(config)
    assert isinstance(model, Tacotron) and isinstance(config, TacotronConfig)
    saved = setup_model(config).init_params(seed=1, device="cpu")
    torch.save({"model": saved.module.state_dict(), "r": 1}, tmp_path / "model_torch.pt")
    loaded = model.load_checkpoint(config, checkpoint_dir=str(tmp_path), device="cpu")
    assert loaded.r == 1 and loaded.r_init == 2
    torch.save({"model": {"embedding.weight": torch.zeros(24, 32)}}, tmp_path / "ref.pth")
    with pytest.raises(NotImplementedError, match="F41"):
        model.load_checkpoint(config, checkpoint_path=str(tmp_path / "ref.pth"), device="cpu")
