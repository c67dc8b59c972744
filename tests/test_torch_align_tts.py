"""The port's AlignTTS (``tts_tpu_torch.models.align_tts``,
``utils.convert.align_tts_from_jax_params``) against the JAX package's, on
the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``: every leaf N(0, 0.05²), norm scales
1 + N(0, 0.05²), the MDN head included), the duration predictor's output
bias at GlowTTS's ``DURATION_BIAS`` (about 6 frames a token), carried into
the port with the MDN head (which training runs), at small widths (hidden 32, 2
heads, 2 layers or 3 dilations, 16 mels). ``inference`` with each block type
at B = 2 has equal durations and ``y_lengths`` and mels within 1e-5; the
durations are rounded at .5, so each test prints the smallest distance of a
predicted duration from a .5 boundary. ``synthesis`` of a sentence agrees
with the JAX package's too.

The JAX package has no reference-layout converter for AlignTTS, so the port
loads its own ``model_torch.pt`` and the JAX parameters, and a
reference-layout file raises (``test_checkpoint_loads_the_ports_own_file``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import drawn_params

from tts_tpu.models.align_tts import AlignTTS as JaxAlignTTS
from tts_tpu.models.align_tts import AlignTTSConfig as JaxAlignTTSConfig
from tts_tpu.utils.synthesis import synthesis as jax_synthesis
from tts_tpu_torch.models.align_tts import AlignTTS, AlignTTSConfig
from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS
from tts_tpu_torch.utils.convert import align_tts_from_jax_params
from tts_tpu_torch.utils.synthesis import synthesis

ATOL = 1e-5
FFT = {"hidden_channels_ffn": 48, "num_heads": 2, "num_layers": 2, "dropout_p": 0.0}
CONV = {"kernel_size": 4, "dilations": [1, 2, 1], "num_conv_blocks": 2}
BLOCKS = {"fftransformer": FFT, "residual_conv_bn": CONV}


def small_config(cls, block="fftransformer", num_chars=40, **kw):
    """``cls`` (either package's ``AlignTTSConfig``) at small widths with
    ``block`` as its encoder and decoder; ``kw`` sets top-level fields."""
    config = cls(**kw)
    a = config.model_args
    a.num_chars, a.out_channels, a.hidden_channels, a.hidden_channels_dp = num_chars, 16, 32, 24
    a.encoder_type = a.decoder_type = block
    a.encoder_params, a.decoder_params = dict(BLOCKS[block]), dict(BLOCKS[block])
    return config


def jax_pair(block="fftransformer", seed=0, **kw):
    """The small JAX ``AlignTTS``, its drawn params (duration bias at
    ``DURATION_BIAS``) and the port's ``AlignTTS`` carrying them."""
    jm = JaxAlignTTS(small_config(JaxAlignTTSConfig, block, **kw))
    params = jax.tree_util.tree_map(np.array, drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                           seed=seed))
    params["params"]["duration_predictor"]["proj"]["bias"] = np.full((1,), DURATION_BIAS,
                                                                     np.float32)
    port = AlignTTS(AlignTTSConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(align_tts_from_jax_params(params))
    return jm, params, port


def _text(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(1, 40, (2, 16)).astype(np.int64), np.array([16, 10], np.int64)


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"
    return err


def half_margin(port, text, lens) -> float:
    """Smallest distance of a valid token's unrounded duration from a .5
    boundary."""
    m = port.module
    x, xl = torch.from_numpy(text), torch.from_numpy(lens)
    with torch.no_grad():
        mask = (torch.arange(x.shape[1])[None] < xl[:, None]).float()[:, :, None]
        o_en = m.encoder(m.emb(x) * mask, mask)
        log = m.duration_predictor(m.mod_layer(o_en) * mask, mask)[..., 0]
    raw = ((torch.exp(log) - 1) * m.args.length_scale)[mask[..., 0] > 0].numpy()
    return float(np.abs(raw - np.floor(raw) - 0.5).min())


@pytest.mark.parametrize("block", list(BLOCKS))
def test_inference_matches_jax(block):
    """B = 2 (16 and 10 tokens) at a 200-frame budget: durations,
    ``y_lengths``, alignments and the mel."""
    jm, params, port = jax_pair(block)
    text, lens = _text()
    want = jm.inference(params, jnp.asarray(text), jnp.asarray(lens), max_frames=200)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(text), torch.from_numpy(lens), max_frames=200)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    assert 20 < int(got["y_lengths"][1]) < int(got["y_lengths"][0]) < 200
    _close(got["alignments"], want["alignments"], what="alignments")
    err = _close(got["model_outputs"], want["model_outputs"], what=block)
    margin = half_margin(port, text, lens)
    print(f"AlignTTS {block}: y_lengths {got['y_lengths'].tolist()}, mel max abs diff "
          f"{err:.3g}, smallest distance of a duration from a .5 boundary {margin:.3g}")
    assert margin > 1e-4


def test_synthesis_matches_jax():
    """``synthesis`` of a sentence on a tokenizer from the config
    (graphemes, ``english_cleaners``): the budget of its tokens, the mel
    cut at ``y_lengths``."""
    text = "Be a voice, not an echo."
    kw = dict(num_chars=None, text_cleaner="english_cleaners", use_phonemes=False)
    jm = JaxAlignTTS.init_from_config(small_config(JaxAlignTTSConfig, **kw))
    params = jax.tree_util.tree_map(np.array, drawn_params(jm.init_params, jax.random.PRNGKey(0)))
    params["params"]["duration_predictor"]["proj"]["bias"] = np.full((1,), DURATION_BIAS,
                                                                     np.float32)
    port = AlignTTS.init_from_config(small_config(AlignTTSConfig, **kw))
    assert port.args.num_chars == jm.config.model_args.num_chars
    port.load_state_dict(align_tts_from_jax_params(params))
    want = jax_synthesis(jm, text, params, use_griffin_lim=False)
    with torch.no_grad():
        got = synthesis(port, text)
    assert got["wav"] is None and got["model_outputs"].shape[0] > 20
    _close(got["model_outputs"], want["model_outputs"], what="mel")


def test_weights_carry_over_strictly(tmp_path):
    """Every leaf of the JAX params lands in the port's state_dict, the MDN
    head's (which training runs) among them, and nothing else does."""
    jm, params, port = jax_pair()
    assert {"mdn_conv1", "mdn_norm", "mdn_conv2"} <= set(params["params"])
    state = align_tts_from_jax_params(params)
    assert {k for k in state if k.startswith("mdn_")} == {
        "mdn_conv1.weight", "mdn_conv1.bias", "mdn_norm.weight", "mdn_norm.bias",
        "mdn_conv2.weight", "mdn_conv2.bias"}
    assert sorted(state) == sorted(port.module.state_dict())
    missing = dict(state)
    missing.pop("proj.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        AlignTTS(port.config).load_state_dict(missing)


def test_checkpoint_loads_the_ports_own_file(tmp_path):
    """``load_checkpoint`` reads the port's ``model_torch.pt`` from a
    directory and decodes as the model it was saved from; a file in another
    layout raises, naming ROADMAP.md item 16."""
    _, _, port = jax_pair("residual_conv_bn")
    torch.save(port.module.state_dict(), tmp_path / "model_torch.pt")
    loaded = AlignTTS(port.config).load_checkpoint(port.config, checkpoint_dir=str(tmp_path),
                                                   device="cpu")
    text, lens = map(torch.from_numpy, _text(1))
    with torch.no_grad():
        a = loaded.inference(text, lens, max_frames=160)["model_outputs"]
        b = port.inference(text, lens, max_frames=160)["model_outputs"]
    assert torch.equal(a, b)
    torch.save({"model": {"encoder.weight": torch.zeros(1)}}, tmp_path / "model_file.pth")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 16"):
        AlignTTS(port.config).load_checkpoint(port.config,
                                              checkpoint_path=str(tmp_path / "model_file.pth"),
                                              device="cpu")
