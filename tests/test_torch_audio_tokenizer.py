"""tts_tpu_torch audio front end, tokenizer and config against the JAX package.

* ``wav_to_mel`` / ``wav_to_mel_cloning``: the same windowed-DFT conv as
  ``jax_transforms``; log-mels agree within 1e-4 (fp32 sums of up to 2048
  terms in another order).
* The pure-Python BPE against HF ``tokenizers`` and against the JAX
  package's ``VoiceBpeTokenizer.encode``: identical ids.
* ``XttsConfig``: the same fields and defaults, JSON round trips both ways.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.audio import jax_transforms as jt
from tts_tpu.audio import mel as jax_mel
from tts_tpu.audio import numpy_transforms as jax_np
from tts_tpu.models.xtts import config as jax_config
from tts_tpu.models.xtts import tokenizer as jax_tokenizer
from tts_tpu.models.xtts.model import wav_to_mel_cloning as jax_wav_to_mel_cloning
from tts_tpu_torch.audio import mel, numpy_transforms, torch_transforms as tt
from tts_tpu_torch.models.xtts import config as port_config
from tts_tpu_torch.models.xtts import tokenizer as port_tokenizer
from tts_tpu_torch.models.xtts.model import wav_to_mel_cloning


def _wav(n=8000, seed=0):
    t = np.arange(n, dtype=np.float32) / 16000.0
    rs = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rs.randn(n)).astype(np.float32)[None]


def test_wav_to_mel_matches_jax():
    """The speaker-encoder front end (16 kHz, 512-point STFT, 64 mels)."""
    wav = _wav()
    kw = dict(n_fft=512, num_mels=64, sample_rate=16000, hop_length=160, win_length=400,
              fmax=8000.0, center=True)
    want = np.asarray(jt.wav_to_mel(jnp.asarray(wav), **kw))
    got = tt.wav_to_mel(torch.from_numpy(wav), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("center", [True, False])
def test_stft_magnitude_matches_jax(center):
    wav = _wav(4000, seed=1)
    want = np.asarray(jt.stft_magnitude(jnp.asarray(wav), 256, 64, 200, center=center,
                                        pad_wav=not center))
    got = tt.stft_magnitude(torch.from_numpy(wav), 256, 64, 200, center=center,
                            pad_wav=not center).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wav_to_mel_cloning_matches_jax():
    wav = _wav(22050, seed=2)
    norms = np.linspace(1.0, 2.0, 80).astype(np.float32)
    want = np.asarray(jax_wav_to_mel_cloning(jnp.asarray(wav), mel_norms=jnp.asarray(norms)))
    got = wav_to_mel_cloning(torch.from_numpy(wav), mel_norms=torch.from_numpy(norms)).numpy()
    assert got.shape == want.shape == (1, 87, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mel_filterbank_and_wav_io_are_the_jax_packages(tmp_path):
    for htk, norm in ((False, "slaney"), (True, None)):
        np.testing.assert_array_equal(
            mel.mel_filterbank(22050, 1024, 80, fmax=8000.0, htk=htk, norm=norm),
            jax_mel.mel_filterbank(22050, 1024, 80, fmax=8000.0, htk=htk, norm=norm),
        )
    wav = _wav(3000)[0]
    np.testing.assert_array_equal(numpy_transforms.resample_wav(wav, 16000, 22050),
                                  jax_np.resample_wav(wav, 16000, 22050))
    path = str(tmp_path / "a.wav")
    numpy_transforms.save_wav(wav=wav, path=path, sample_rate=16000)
    np.testing.assert_array_equal(
        numpy_transforms.load_wav(filename=path, sample_rate=22050, resample=True),
        jax_np.load_wav(filename=path, sample_rate=22050, resample=True),
    )


# ---------------------------------------------------------------------------
def _surfaces_vocab(path):
    """The character vocab of tests/test_synthesizer_surfaces.py."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE

    chars = sorted(set("abcdefghijklmnopqrstuvwxyz[]enspace().,!?' -"))
    vocab = {c: i for i, c in enumerate(chars)}
    vocab["[UNK]"] = len(vocab)
    Tokenizer(BPE(vocab=vocab, merges=[], unk_token="[UNK]")).save(str(path))


def _merges_vocab(path):
    """BPE with merges, a Whitespace pre-tokenizer and added tokens."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {c: i for i, c in enumerate("abcdehlorw")}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "w"), ("r", "l"), ("w", "o"),
              ("wo", "rl"), ("a", "a"), ("aa", "a")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["[UNK]"] = len(vocab)
    tok = Tokenizer(BPE(vocab=vocab, merges=merges, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.add_special_tokens(["[STOP]", "[SPACE]", "[en]", "[es]"])
    tok.save(str(path))


def _char_vocab(path):
    port_tokenizer.write_char_vocab(str(path), "abcdefghijklmnopqrstuvwxyz.,!?'", languages=("en", "es"))


TEXTS = ["Hello there, world!", "hellohello aaaa aaaaa", "Dr. Who paid $5 & 3 cents?",
         "xyz hel,lo!! wor", "aaa   lll."]


@pytest.mark.parametrize("make_vocab", [_surfaces_vocab, _merges_vocab, _char_vocab])
def test_bpe_matches_hf_tokenizers(tmp_path, make_vocab):
    from tokenizers import Tokenizer

    path = tmp_path / "vocab.json"
    make_vocab(path)
    hf = Tokenizer.from_file(str(path))
    ours = port_tokenizer.BpeTokenizer.from_file(str(path))
    for text in TEXTS + [f"[en]{t.replace(' ', '[SPACE]')}" for t in TEXTS]:
        assert ours.encode(text) == hf.encode(text).ids, text
    assert ours.token_to_id("[UNK]") == hf.token_to_id("[UNK]")


@pytest.mark.parametrize("make_vocab", [_surfaces_vocab, _merges_vocab, _char_vocab])
@pytest.mark.parametrize("lang", ["en", "es"])
def test_voice_bpe_encode_matches_jax(tmp_path, make_vocab, lang):
    path = str(tmp_path / "vocab.json")
    make_vocab(path)
    want = jax_tokenizer.VoiceBpeTokenizer(vocab_file=path)
    got = port_tokenizer.VoiceBpeTokenizer(vocab_file=path)
    for text in TEXTS:
        assert got.encode(text, lang) == want.encode(text, lang), text
    ids = got.encode(TEXTS[0], lang)
    assert got.decode(ids) == want.decode(ids)


def test_multilingual_cleaners_match_jax():
    for text, lang in [("Hello & 3 worlds!", "en"), ('El "gato" & yo', "es"),
                       ("Ich habe 21 Äpfel (rot).", "de"), ("İstanbul 5", "tr"),
                       ("Il a 2 chats @ home", "fr")]:
        assert port_tokenizer.multilingual_cleaners(text, lang) == \
            jax_tokenizer.multilingual_cleaners(text, lang)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["XttsArgs", "XttsConfig", "XttsAudioConfig"])
def test_config_fields_and_defaults_match_jax(name):
    port_cls, jax_cls = getattr(port_config, name), getattr(jax_config, name)

    def spec(cls):
        obj = cls()
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(cls)]

    port_spec, jax_spec = spec(port_cls), spec(jax_cls)
    assert [n for n, _ in port_spec] == [n for n, _ in jax_spec]
    for (n, a), (_, b) in zip(port_spec, jax_spec):
        if dataclasses.is_dataclass(a):
            a, b = a.to_dict(), b.to_dict()
        assert a == b, n


def test_config_json_round_trips_both_ways():
    port = port_config.XttsConfig()
    port.model_args.gpt_layers = 3
    port.temperature = 0.5
    as_jax = jax_config.XttsConfig.from_dict(json.loads(json.dumps(port.to_dict())))
    assert as_jax.model_args.gpt_layers == 3 and as_jax.temperature == 0.5
    back = port_config.XttsConfig.from_dict(json.loads(json.dumps(as_jax.to_dict())))
    assert back.to_dict() == port.to_dict()
    assert isinstance(back.model_args, port_config.XttsArgs)
