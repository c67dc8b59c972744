"""GST and Capacitron Tacotron2, and Tacotron v1, through the port's user
surfaces, against the JAX package, on the CPU: ``synthesis`` and the
``Synthesizer`` with a ``style_wav``, ``TTS.tts(style_wav=...,
style_text=...)``, the ``tts`` command line's style flags, the server's
``/api/tts?style_wav=``, and the zoo's two Capacitron voices by name with
their HiFiGAN, offline.

One tiny Tacotron2 with GST and one with Capacitron
(``test_torch_slice``-style: ``test_torch_tacotron2.small_config`` with 16
mels, graphemes, folded norms as a converted checkpoint has them; the
stopnet never fires) and the tiny HiFiGAN of
``test_torch_tacotron2_slice`` are written as the JAX package's ``.msgpack``
checkpoints, the port's ``model_torch.pt`` and the reference layout's
``model_file.pth``. The style layers' weights are drawn at unit gain
(``test_torch_style_tacotron.unit_gain``), so that a style reference
changes the audio. Capacitron's draw is one standard normal vector: the
JAX wrapper keys every call with the same noise key, so the JAX draw is
taken once (the prior's ``z``) and handed to the port by replacing
``tts_tpu_torch.layers.capacitron.normal``.

Divergences and faults named here:

* F36: the Mandarin phonemizer is never available in the port, and the
  zoo's ``tacotron2-DDC-GST`` raises before any fetch;
* F37 (kept): ``style_text`` changes nothing, in either package;
* F40: Tacotron v1's linear spectrogram goes through
  ``AudioProcessor.inv_spectrogram`` in the port, where the JAX
  ``synthesis`` hands it to ``inv_melspectrogram`` (which cannot take it);
  a mel vocoder with a Tacotron v1 raises.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import io
import shutil
import threading
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_glow_tts import drawn_params
from test_torch_style_tacotron import CAPACITRON, GST, V1, unit_gain
from test_torch_tacotron2 import small_config, unit_gain_convs, with_stopnet
from test_torch_tacotron2_slice import (
    AUDIO,
    DECODE_SCALE,
    MODEL_KW,
    write_hifigan,
    write_json,
    zoo_dir,
)

from tts_tpu.audio.processor import AudioProcessor as JaxAudioProcessor
from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tts_tpu.models.tacotron2 import Tacotron2Config as JaxTacotron2Config
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesis import synthesis as jax_synthesis
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.config.shared import BaseAudioConfig
from tts_tpu_torch.layers import capacitron
from tts_tpu_torch.models.tacotron2 import Tacotron, Tacotron2, Tacotron2Config, TacotronConfig
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.text import phonemizers
from tts_tpu_torch.utils import manage
from tts_tpu_torch.utils.convert import reference_tacotron2_state, tacotron2_from_jax_params
from tts_tpu_torch.utils.synthesis import synthesis
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

ATOL = 1e-5
TEXT = "Be a voice, not an echo."
STYLE_TEXT = "A quiet reading voice."
STYLES = {"gst": dict(use_gst=True, gst=GST),
          "capacitron": dict(use_capacitron_vae=True, capacitron_vae=CAPACITRON)}
LAYERS = {"gst": "gst_layer", "capacitron": "capacitron_vae_layer"}
CAPACITRON_ZOO = ["tts_models/en/blizzard2013/capacitron-t2-c50",
                  "tts_models/en/blizzard2013/capacitron-t2-c150_v2"]
BLIZZARD_HIFIGAN = "vocoder_models/en/blizzard2013/hifigan_v2"


def write_style_tacotron2(d, style):
    """The tiny Tacotron2 with ``style`` in the JAX, port and reference
    layouts with its ``config.json`` under ``d``, the style layer's weights
    at unit gain; returns the JAX model and params."""
    d.mkdir()
    config = small_config(JaxTacotron2Config, **MODEL_KW, **STYLES[style],
                          audio=JaxAudioConfig(**AUDIO))
    jm = JaxTacotron2.init_from_config(config)
    params = with_stopnet(unit_gain_convs(drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                       scale=DECODE_SCALE), DECODE_SCALE),
                          0.0, -10.0)
    params["params"][LAYERS[style]] = unit_gain(params["params"][LAYERS[style]], seed=4)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    port = Tacotron2(Tacotron2Config.from_dict(jm.config.to_dict()))
    port.load_state_dict(tacotron2_from_jax_params(params))
    state = port.module.state_dict()
    torch.save(state, d / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_tacotron2_state(state).items()}}, d / "model_file.pth")
    write_json(d / "config.json", jm.config.to_dict())
    return jm, params


@pytest.fixture(scope="module")
def style_dir(tmp_path_factory):
    """``gst/`` and ``capacitron/`` Tacotron2 directories, ``voc/`` the
    HiFiGAN, ``style.wav`` a 0.6 s style reference at 16 kHz; and the JAX
    Capacitron's draw, the prior's ``z`` under the JAX wrapper's noise key."""
    d = tmp_path_factory.mktemp("style")
    models = {style: write_style_tacotron2(d / style, style) for style in STYLES}
    write_hifigan(d / "voc")
    t = np.arange(9600) / 16000
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    scipy.io.wavfile.write(d / "style.wav", 16000, (wav * 32767).astype(np.int16))
    jm, params = models["capacitron"]
    x = jnp.ones((1, 4), jnp.int32)
    enc = jm.module.apply(params, x, jnp.array([4]), None, False, method=type(jm.module)._encode,
                          rngs={"dropout": jax.random.PRNGKey(0),
                                "noise": jax.random.PRNGKey(7)})[0]
    return d, np.asarray(enc[:, 0, -CAPACITRON["capacitron_VAE_embedding_dim"]:])


@pytest.fixture
def jax_draw(style_dir, monkeypatch):
    """The port's Capacitron draws the JAX package's vector."""
    eps = torch.from_numpy(style_dir[1].copy())
    monkeypatch.setattr(capacitron, "normal", lambda shape, generator=None: eps.expand(shape))
    return eps


def port_synth(d, style, weights="model_file.pth"):
    return Synthesizer(tts_checkpoint=str(d / style / weights),
                       tts_config_path=str(d / style / "config.json"), device="cpu",
                       vocoder_checkpoint=str(d / "voc" / weights),
                       vocoder_config=str(d / "voc" / "config.json"))


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs diff {err}"


def _pcm(wav):
    wav = np.asarray(wav, np.float32)
    return (wav * (32767 / max(0.01, float(np.abs(wav).max())))).astype(np.int16)


@pytest.mark.parametrize("style", list(STYLES))
def test_synthesizer_with_style_wav_matches_jax(style_dir, jax_draw, style):
    """The JAX ``Synthesizer`` on the ``.msgpack`` files and the port's on
    the reference-layout files, with the same ``style_wav`` path (its mel
    through each package's ``AudioProcessor``) and HiFiGAN: waveforms within
    1e-5; without the style the audio differs (GST's zero style,
    Capacitron's prior)."""
    d = style_dir[0]
    style_wav = str(d / "style.wav")
    jax_synth = JaxSynthesizer(tts_checkpoint=str(d / style / "model.msgpack"),
                               tts_config_path=str(d / style / "config.json"),
                               vocoder_checkpoint=str(d / "voc" / "model.msgpack"),
                               vocoder_config=str(d / "voc" / "config.json"))
    want = np.asarray(jax_synth.tts(TEXT, style_wav=style_wav), np.float32)
    synth = port_synth(d, style)
    got = np.asarray(synth.tts(TEXT, style_wav=style_wav), np.float32)
    _close(got, want)
    plain = np.asarray(synth.tts(TEXT), np.float32)
    assert plain.shape == got.shape and float(np.abs(plain - got).max()) > 1e-3


def test_synthesis_style_mel_and_f37_style_text(style_dir, jax_draw):
    """``synthesis`` puts the ``AudioProcessor``'s mel of the style wav
    (a path or its samples alike) into ``aux_input["style_mel"]`` as ``[1,
    T, M]``, as the JAX ``synthesis`` does, and ``style_text`` beside it,
    where nothing reads it (F37): the audio with and without it is equal.
    A ``style_wav`` without an ``AudioProcessor`` raises the JAX package's
    ``ValueError``."""
    d = style_dir[0]
    synth = port_synth(d, "capacitron")
    model, ap = synth.tts_model, synth.ap
    samples = ap.load_wav(str(d / "style.wav"))
    by_path = synthesis(model, TEXT, style_wav=str(d / "style.wav"), ap=ap)
    by_samples = synthesis(model, TEXT, style_wav=samples, ap=ap, style_text=STYLE_TEXT)
    np.testing.assert_array_equal(by_path["model_outputs"], by_samples["model_outputs"])
    jax_ap = JaxAudioProcessor.init_from_config(JaxAudioConfig(**AUDIO), verbose=False)
    want_mel = jax_ap.melspectrogram(samples).T[None]
    recorded = {}
    real = model.module.inference

    def record(*args, aux_input=None, **kw):
        recorded.update(aux_input)
        return real(*args, aux_input=aux_input, **kw)

    model.module.inference = record
    synthesis(model, TEXT, style_wav=samples, ap=ap, style_text=STYLE_TEXT)
    model.module.inference = real
    _close(recorded["style_mel"], want_mel)
    assert recorded["style_text"] == STYLE_TEXT
    with_text = np.asarray(synth.tts(TEXT, style_wav=samples, style_text=STYLE_TEXT))
    np.testing.assert_array_equal(with_text, np.asarray(synth.tts(TEXT, style_wav=samples)))
    for fn, kw in ((synthesis, dict(model=model)), (jax_synthesis, dict(
            model=JaxTacotron2.init_from_config(JaxTacotron2Config()), params=None))):
        with pytest.raises(ValueError, match="no AudioProcessor is available"):
            fn(text=TEXT, style_wav=samples, ap=None, **kw)


def test_tts_api_cli_and_server_take_the_style(style_dir, jax_draw, tmp_path):
    """``TTS.tts(style_wav=..., style_text=...)`` speaks as the
    ``Synthesizer`` does; ``tts --style_wav`` and its aliases
    ``--gst_style`` and ``--capacitron_style_wav``, with
    ``--capacitron_style_text``, write that audio; ``/api/tts?style_wav=``
    (a server-side path) answers it, serially."""
    d = style_dir[0]
    style_wav = str(d / "style.wav")
    paths = dict(model_path=str(d / "gst" / "model_torch.pt"),
                 config_path=str(d / "gst" / "config.json"),
                 vocoder_path=str(d / "voc" / "model_torch.pt"),
                 vocoder_config_path=str(d / "voc" / "config.json"))
    api = TTS(**paths, device="cpu")
    want = np.asarray(api.tts(TEXT, style_wav=style_wav, style_text=STYLE_TEXT), np.float32)
    _close(want, port_synth(d, "gst", "model_torch.pt").tts(TEXT, style_wav=style_wav))
    api.tts_to_file(TEXT, style_wav=style_wav, file_path=str(tmp_path / "api.wav"))
    _, ref = scipy.io.wavfile.read(tmp_path / "api.wav")
    for flag in ("--style_wav", "--gst_style", "--capacitron_style_wav"):
        out = tmp_path / f"{flag[2:]}.wav"
        port_cli(["--text", TEXT, "--out_path", str(out), "--device", "cpu", flag, style_wav,
                  "--capacitron_style_text", STYLE_TEXT]
                 + [a for k, v in paths.items() for a in (f"--{k}", v)])
        _, got = scipy.io.wavfile.read(out)
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1, flag
    args = build_parser().parse_args([a for k, v in paths.items() for a in (f"--{k}", v)]
                                     + ["--max_batch", "4", "--port", "0", "--device", "cpu"])
    srv = server_from_args(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?" + urllib.parse.urlencode(
            {"text": TEXT, "style_wav": style_wav})
        with urllib.request.urlopen(url, timeout=120) as r:
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(r.read()))
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/",
                                    timeout=30) as r:
            assert b'id="style_wav"' in r.read()
    finally:
        close_server(srv)
    assert sr == 16000 and np.abs(pcm.astype(np.int32) - _pcm(want).astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# the zoo by name, offline
# ---------------------------------------------------------------------------


@pytest.fixture
def offline(style_dir, tmp_path, monkeypatch):
    """A ``TTS_HOME`` holding the Capacitron Tacotron2 (reference layout)
    under both Capacitron names and the HiFiGAN under the blizzard2013
    ``hifigan_v2``; any fetch fails."""
    d = style_dir[0]
    for name in CAPACITRON_ZOO:
        shutil.copytree(d / "capacitron", zoo_dir(tmp_path, name))
    shutil.copytree(d / "voc", zoo_dir(tmp_path, BLIZZARD_HIFIGAN))
    for sub in (tmp_path / "tts_tpu").iterdir():
        for name in ("model.msgpack", "model_torch.pt"):
            (sub / name).unlink(missing_ok=True)
    monkeypatch.setenv("TTS_HOME", str(tmp_path))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return tmp_path


@pytest.mark.parametrize("name", CAPACITRON_ZOO)
def test_capacitron_voices_by_name_speak_offline(offline, style_dir, jax_draw, name, tmp_path):
    """Each Capacitron entry loads by name with the blizzard2013 HiFiGAN,
    fetching nothing, and speaks with a style reference as the same files
    by path do; ``tts --model_name ... --style_wav`` writes it."""
    d, style_wav = style_dir[0], str(style_dir[0] / "style.wav")
    tts = TTS(model_name=name, device="cpu")
    synth = tts.synthesizer
    assert synth.tts_config.use_capacitron_vae and synth.vocoder_config is not None
    by_name = np.asarray(tts.tts(TEXT, style_wav=style_wav), np.float32)
    np.testing.assert_array_equal(by_name, port_synth(d, "capacitron").tts(
        TEXT, style_wav=style_wav))
    out = tmp_path / "cli.wav"
    port_cli(["--text", TEXT, "--model_name", name, "--style_wav", style_wav,
              "--capacitron_style_text", STYLE_TEXT, "--out_path", str(out), "--device", "cpu"])
    _, pcm = scipy.io.wavfile.read(out)
    assert np.abs(pcm.astype(np.int32) - _pcm(by_name).astype(np.int32)).max() <= 1


def test_f36_mandarin_gst_and_tacotron_v1_zoo_entries_raise(offline):
    """F36: the Mandarin phonemizer is unavailable in the port whatever is
    installed, building one raises naming F36, and the zoo's Mandarin GST
    Tacotron2 raises before any fetch; ``tacotron-DDC`` raises naming its
    missing converter (F41)."""
    assert not phonemizers.ZH_CN_Phonemizer.is_available()
    assert "zh-cn" not in phonemizers.DEF_LANG_TO_PHONEMIZER
    with pytest.raises(NotImplementedError, match="F36"):
        phonemizers.get_phonemizer_by_name("zh_cn_phonemizer")
    with pytest.raises(NotImplementedError, match="F36"):
        TTS(model_name="tts_models/zh-CN/baker/tacotron2-DDC-GST", device="cpu")
    with pytest.raises(NotImplementedError, match="F41"):
        TTS(model_name="tts_models/en/sam/tacotron-DDC", device="cpu")


# ---------------------------------------------------------------------------
# Tacotron v1: Griffin-Lim on its linear spectrogram (F40)
# ---------------------------------------------------------------------------


def test_f40_tacotron_v1_speaks_through_inv_spectrogram(style_dir, tmp_path):
    """A Tacotron v1 checkpoint file speaks through Griffin-Lim on its linear
    spectrogram: the port's ``synthesis`` equals the JAX
    ``AudioProcessor.inv_spectrogram`` of the same spectrogram (one seed of
    numpy's generator before each). The JAX ``synthesis`` inverts every
    output as a mel, which a linear spectrogram is not: its
    ``inv_melspectrogram`` raises on one. A mel vocoder with a Tacotron v1
    raises (F40)."""
    d = tmp_path / "v1"
    d.mkdir()
    config = TacotronConfig(**dict(V1, num_chars=None, decoder_output_dim=16,
                                   out_channels=AUDIO["fft_size"] // 2 + 1),
                            audio=BaseAudioConfig(**AUDIO), text_cleaner="english_cleaners")
    model = Tacotron.init_from_config(config).init_params(seed=3, device="cpu")
    torch.save(model.module.state_dict(), d / "model_torch.pt")
    write_json(d / "config.json", config.to_dict())
    synth = Synthesizer(tts_checkpoint=str(d / "model_torch.pt"),
                        tts_config_path=str(d / "config.json"), device="cpu")
    np.random.seed(0)
    out = synthesis(synth.tts_model, TEXT, use_griffin_lim=True, ap=synth.ap)
    linear = out["model_outputs"]
    assert linear.shape[1] == AUDIO["fft_size"] // 2 + 1 and out["wav"] is not None
    jax_ap = JaxAudioProcessor.init_from_config(JaxAudioConfig(**AUDIO), verbose=False)
    np.random.seed(0)
    _close(out["wav"], jax_ap.inv_spectrogram(linear.T), atol=1e-4)
    with pytest.raises(ValueError):
        jax_ap.inv_melspectrogram(linear.T)
    wav = synth.tts(TEXT)
    assert len(wav) > SENTENCE_GAP and np.isfinite(wav).all()
    with pytest.raises(NotImplementedError, match="F40"):
        Synthesizer(tts_checkpoint=str(d / "model_torch.pt"),
                    tts_config_path=str(d / "config.json"), device="cpu",
                    vocoder_checkpoint=str(style_dir[0] / "voc" / "model_torch.pt"),
                    vocoder_config=str(style_dir[0] / "voc" / "config.json"))
