"""The XTTS v1 layout (``gpt_use_perceiver_resampler=False``) in the port
against the JAX package on the CPU: every conditioning mel frame is a prompt
latent (no perceiver), the conditioning mel is one coarse mel over the whole
clip (``n_fft`` 4096, hop 1024, no chunks), and a reference checkpoint
holds no ``gpt.conditioning_perceiver.*``.

The tiny XTTS of ``helpers.tiny_xtts_config`` (2 layers, 64 wide) in the v1
layout, its weights a synthetic reference-layout checkpoint
(``test_torch_convert.reference_state`` without the perceiver's keys), read
by the JAX package's converter with ``use_perceiver=False`` and by the
port's ``load_reference_xtts``. Latents within 1e-5 of their peak; greedy
tokens identical. F46 (the JAX ``convert_xtts`` raises on a v1 checkpoint)
is named here.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from helpers import tiny_xtts_config
from test_torch_convert import reference_state
from test_torch_tortoise import peak_close

from tts_tpu.models.xtts import Xtts as JaxXtts
from tts_tpu.utils import convert as jax_convert
from tts_tpu_torch.api import TTS
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
from tts_tpu_torch.utils import convert, manage

XTTS_V1 = "tts_models/multilingual/multi-dataset/xtts_v1.1"


def v1_config():
    """The tiny config in the v1 layout, its text start token the one the
    model directory's ``vocab.json`` gives (``[START]`` is id 3 there)."""
    config = tiny_xtts_config()
    config.model_args.gpt_use_perceiver_resampler = False
    config.model_args.gpt_start_text_token = 3
    return config


def v1_state(config):
    """A reference-layout XTTS v1 checkpoint: the v2 layout without the
    perceiver."""
    return {k: v for k, v in reference_state(config.model_args).items()
            if not k.startswith("gpt.conditioning_perceiver.")}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX ``Xtts`` (v1 layout) on the JAX converters' tree of the
    checkpoint, the port's loaded from the checkpoint's ``model.pth`` in a
    model directory, and that directory."""
    config = v1_config()
    state = v1_state(config)
    args = config.model_args
    jm = JaxXtts(config)
    jm.gpt_params = jax_convert.convert_xtts_gpt(state, layers=args.gpt_layers,
                                                 heads=args.gpt_n_heads, use_perceiver=False)
    jm.decoder_params = jax_convert.convert_hifi_decoder(state)
    jm.mel_stats = jnp.asarray(state["mel_stats"])
    d = tmp_path_factory.mktemp("xtts_v1")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, d / "model.pth")
    with open(d / "config.json", "w") as f:
        json.dump(config.to_dict(), f, default=str)
    write_char_vocab(str(d / "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'")
    tm = Xtts(XttsConfig.from_dict(config.to_dict()))
    tm.load_checkpoint(tm.config, checkpoint_dir=str(d), device="cpu")
    return jm, tm, d


def test_v1_model_has_no_perceiver(pair):
    jm, tm, _ = pair
    assert tm.gpt.conditioning_perceiver is None
    assert not any(k.startswith("gpt.conditioning_perceiver") for k in tm.state_dict())
    assert set(convert.xtts_from_jax_params(jm.gpt_params, jm.decoder_params)) == \
        set(tm.state_dict())


def test_style_emb_keeps_every_frame(pair):
    """Without the perceiver, the conditioning encoder's output for each of
    the mel's frames is a prompt latent."""
    jm, tm, _ = pair
    mel = np.random.RandomState(2).randn(2, 37, 80).astype(np.float32)
    want = jm.gpt.apply(jm.gpt_params, jnp.asarray(mel), method=jm.gpt.get_style_emb)
    got = tm.gpt.get_style_emb(torch.from_numpy(mel))
    assert got.shape == (2, 37, 64)
    peak_close(got, want, 1e-5, "style embedding")


def _clip(seconds, seed=0):
    t = np.arange(int(seconds * 22050)) / 22050
    return (0.3 * np.sin(2 * np.pi * 170 * t)
            + 0.02 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


def test_v1_conditioning_is_one_coarse_mel(pair):
    """``get_gpt_cond_latents`` of a 7 s clip: one mel at ``n_fft`` 4096,
    hop 1024 over the whole clip (no 6 s chunks, the ``mel_stats`` norms),
    one latent a frame: 151 latents."""
    jm, tm, _ = pair
    audio = _clip(7.0)
    want = jm.get_gpt_cond_latents(audio, 22050)
    got = tm.get_gpt_cond_latents(audio, 22050)
    assert got.shape == (1, 7 * 22050 // 1024 + 1, 64) == tuple(want.shape)
    peak_close(got, want, 1e-5, "v1 conditioning latents")


def test_greedy_tokens_identical_on_the_long_prompt(pair):
    """Greedy decoding (``top_k`` 1) behind the v1 prompt (151 latents,
    then the text): tokens and lengths identical, latents within 1e-5 of
    their peak."""
    jm, tm, _ = pair
    cond = np.array(jm.get_gpt_cond_latents(_clip(7.0), 22050))
    rs = np.random.RandomState(5)
    text = rs.randint(5, 48, (2, 12))
    lengths = np.asarray([12, 9])
    kw = dict(max_new_tokens=16, temperature=0.75, top_k=1, top_p=0.85, repetition_penalty=5.0)
    cond2 = np.repeat(cond, 2, axis=0)
    want = jm.gpt.apply(jm.gpt_params, jnp.asarray(cond2), jnp.asarray(text),
                        jnp.asarray(lengths), jax.random.PRNGKey(3), method=jm.gpt.generate, **kw)
    got = tm.gpt.generate(torch.from_numpy(cond2), torch.from_numpy(text),
                          torch.from_numpy(lengths), None, **kw)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["code_lengths"].numpy(), np.asarray(want["code_lengths"]))
    peak_close(got["latents"], want["latents"], 1e-5, "latents")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield "/".join(path), np.asarray(tree)


def test_f46_converter_reads_a_checkpoint_without_the_perceiver():
    """F46. The JAX ``convert_xtts`` (and ``convert_xtts_gpt`` at its default)
    reads the perceiver's keys from every checkpoint and raises ``KeyError``
    on a v1 one; the port's reads the layout from the checkpoint and gives
    the JAX converters' tree with ``use_perceiver=False``, leaf for leaf."""
    config = v1_config()
    state = {k: v for k, v in v1_state(config).items() if k != "mel_stats"}
    kw = dict(layers=config.model_args.gpt_layers, heads=config.model_args.gpt_n_heads)
    with pytest.raises(KeyError, match="conditioning_perceiver"):
        jax_convert.convert_xtts(dict(state), **kw)
    gpt, dec = convert.convert_xtts(dict(state), **kw)
    want_gpt = jax_convert.convert_xtts_gpt(dict(state), use_perceiver=False, **kw)
    want_dec = jax_convert.convert_hifi_decoder(dict(state))
    for got, want in ((gpt, want_gpt), (dec, want_dec)):
        g, w = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert "conditioning_perceiver" not in gpt["params"]


def test_xtts_v1_by_zoo_name_equals_the_path_load(pair, tmp_path, monkeypatch):
    """The zoo's ``xtts_v1.1`` (no longer refused) loads its directory
    (``model.pth``, ``config.json``, ``vocab.json``) with nothing fetched,
    and clones a voice as the same files loaded by path, sample for sample."""
    import shutil

    _, _, d = pair
    home = tmp_path / "home"
    shutil.copytree(d, home / "tts_tpu" / XTTS_V1.replace("/", "--"))
    monkeypatch.setenv("TTS_HOME", str(home))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    assert manage.unported_reason(XTTS_V1, manage.ModelManager().models_dict) is None
    wav = tmp_path / "ref.wav"
    scipy.io.wavfile.write(wav, 22050, (_clip(3.0) * 32767).astype(np.int16))
    by_name = TTS(model_name=XTTS_V1, device="cpu")
    by_path = TTS(model_path=str(d), device="cpu")
    assert by_name.synthesizer.tts_config.model_args.gpt_use_perceiver_resampler is False
    kw = dict(speaker_wav=str(wav), language="en", max_new_tokens=12)
    got = np.asarray(by_name.tts("hello there.", **kw))
    np.testing.assert_array_equal(got, np.asarray(by_path.tts("hello there.", **kw)))
    assert len(got) > 10000 and np.isfinite(got).all()
