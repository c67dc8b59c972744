"""Tacotron2 with HiFiGAN through the port's user surfaces, against the JAX
package, on the CPU: the ``Synthesizer``'s mel → vocoder bridge,
``TTS(model_path=..., vocoder_path=...)``, the ``tts`` command line's
``--vocoder_path``, the server (which serves a mel model serially), and the
zoo by name: ``tts_models/en/ljspeech/tacotron2-DDC`` with its
``hifigan_v2`` and the other Tacotron2 entries with their vocoders.

One tiny Tacotron2 (``test_torch_tacotron2.small_config`` with 16 mels,
graphemes with ``english_cleaners``, folded norms as a converted checkpoint
has them) and one tiny HiFiGAN (upsampling [8, 8], 32 channels) at 16 kHz,
hop 64, are written as the JAX package's ``.msgpack`` checkpoints, the
port's ``model_torch.pt`` and the reference layout's ``model_file.pth``,
each beside its ``config.json``. The stopnet never fires (weight 0, bias
-10), so every sentence decodes its whole budget, as random weights do; the
free-running stop is held in ``test_torch_tacotron2.py``. The same text goes
through the JAX ``Synthesizer`` and the port's; the waveforms, each sentence
trimmed at its endpoint as both packages trim a model loaded from a file,
agree within 1e-5.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import json
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
from test_torch_tacotron2 import small_config, unit_gain_convs, with_stopnet

from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tts_tpu.models.tacotron2 import Tacotron2Config as JaxTacotron2Config
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu.vocoder.configs import HifiganConfig as JaxHifiganConfig
from tts_tpu.vocoder.utils import make_generator_from_config as jax_make_generator
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models import config_from_dict
from tts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tts_tpu_torch.server.batching import DynamicBatcher
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    reference_melgan_state,
    reference_tacotron2_state,
    tacotron2_from_jax_params,
)
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer
from tts_tpu_torch.vocoder.utils import make_generator_from_config

ATOL = 1e-5
# weights N(0, 0.1²): at 0.3 the 64-wide LSTMs amplify their state's fp32
# rounding step by step, to 6e-5 after 320 steps of a whole budget
DECODE_SCALE = 0.1
TEXT = "Be a voice, not an echo. Prior to November 22, 1963."
AUDIO = dict(sample_rate=16000, fft_size=256, win_length=256, hop_length=64, num_mels=16,
             griffin_lim_iters=30, trim_db=3)
HIFIGAN = {"upsample_factors": [8, 8], "upsample_kernel_sizes": [16, 16],
           "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 5],
           "resblock_dilation_sizes": [[1, 3], [1, 3]], "resblock_type": "1"}
DDC = "tts_models/en/ljspeech/tacotron2-DDC"
HIFIGAN_V2 = "vocoder_models/en/ljspeech/hifigan_v2"
MODEL_KW = dict(out_channels=16, num_chars=None, text_cleaner="english_cleaners",
                use_phonemes=False, norm_type="folded")


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def write_tacotron2(d, seed=0, **kw):
    """The tiny Tacotron2 in the JAX, port and reference layouts with its
    ``config.json`` under ``d``; returns the port's config."""
    d.mkdir()
    config = small_config(JaxTacotron2Config, **MODEL_KW, **kw, audio=JaxAudioConfig(**AUDIO))
    jm = JaxTacotron2.init_from_config(config)
    params = with_stopnet(unit_gain_convs(drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                       seed=seed, scale=DECODE_SCALE),
                                          DECODE_SCALE), 0.0, -10.0)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    port_config = Tacotron2Config.from_dict(jm.config.to_dict())
    port = Tacotron2(port_config)
    port.load_state_dict(tacotron2_from_jax_params(params))
    state = port.module.state_dict()
    torch.save(state, d / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_tacotron2_state(state).items()}}, d / "model_file.pth")
    write_json(d / "config.json", jm.config.to_dict())
    return port_config


def write_hifigan(d, seed=1):
    """The tiny HiFiGAN in the three layouts under ``d`` (the reference
    layout holds the generator under ``model_g.``, weight norm folded)."""
    d.mkdir()
    vconfig = JaxHifiganConfig(audio=JaxAudioConfig(**AUDIO))
    vconfig.generator_model_params = dict(HIFIGAN)
    gen = jax_make_generator(vconfig)
    vparams = drawn_params(gen.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), seed=seed,
                           scale=0.15)
    save_checkpoint(str(d / "model.msgpack"), vparams, config=vconfig)
    port_gen = make_generator_from_config(config_from_dict(vconfig.to_dict()))
    port_gen.load_state_dict(flax_to_state_dict(vparams), strict=True)
    torch.save(port_gen.state_dict(), d / "model_torch.pt")
    torch.save({"model": {"model_g." + k: v for k, v in port_gen.state_dict().items()}},
               d / "model_file.pth")
    write_json(d / "config.json", vconfig.to_dict())


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tacotron2_hifigan")
    write_tacotron2(d / "t2")
    write_hifigan(d / "voc")
    return d


def port_synth(d, weights="model_torch.pt"):
    return Synthesizer(tts_checkpoint=str(d / "t2" / weights),
                       tts_config_path=str(d / "t2" / "config.json"), device="cpu",
                       vocoder_checkpoint=str(d / "voc" / weights),
                       vocoder_config=str(d / "voc" / "config.json"))


@pytest.fixture(scope="module")
def jax_wav(pair_dir):
    synth = JaxSynthesizer(tts_checkpoint=str(pair_dir / "t2" / "model.msgpack"),
                           tts_config_path=str(pair_dir / "t2" / "config.json"),
                           vocoder_checkpoint=str(pair_dir / "voc" / "model.msgpack"),
                           vocoder_config=str(pair_dir / "voc" / "config.json"))
    return np.asarray(synth.tts(TEXT), np.float32)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs diff {err}"


def test_synthesizer_with_hifigan_matches_jax(pair_dir, jax_wav):
    """Two sentences, each decoded for its whole budget of ``budget // r``
    steps, cut at ``mel_lengths``, vocoded by HiFiGAN (the bridge is the
    identity: one audio config), trimmed and followed by the 10000-sample
    gap; the reference-layout pair speaks as the port's own files do."""
    synth = port_synth(pair_dir)
    assert synth.output_sample_rate == 16000 and synth.tts_model.r == 2
    wav = np.asarray(synth.tts(TEXT), np.float32)
    _close(wav, jax_wav)
    assert np.all(wav[-SENTENCE_GAP:] == 0) and np.abs(wav).max() > 0.01
    reference = np.asarray(port_synth(pair_dir, "model_file.pth").tts(TEXT), np.float32)
    np.testing.assert_array_equal(reference, wav)


def test_tts_api_and_cli_with_vocoder_path(pair_dir, jax_wav, tmp_path):
    """``TTS(model_path=..., vocoder_path=...)`` speaks as the JAX
    ``Synthesizer`` does, and ``tts --model_path --vocoder_path`` on the
    reference-layout files writes its file within one int16 step."""
    api = TTS(model_path=str(pair_dir / "t2" / "model_torch.pt"),
              config_path=str(pair_dir / "t2" / "config.json"),
              vocoder_path=str(pair_dir / "voc" / "model_torch.pt"),
              vocoder_config_path=str(pair_dir / "voc" / "config.json"), device="cpu")
    _close(api.tts(TEXT), jax_wav)
    want = api.tts_to_file(TEXT, file_path=str(tmp_path / "api.wav"))
    out = tmp_path / "cli.wav"
    port_cli(["--text", TEXT, "--model_path", str(pair_dir / "t2" / "model_file.pth"),
              "--config_path", str(pair_dir / "t2" / "config.json"), "--vocoder_path",
              str(pair_dir / "voc" / "model_file.pth"), "--vocoder_config_path",
              str(pair_dir / "voc" / "config.json"), "--out_path", str(out), "--device", "cpu"])
    sr, got = scipy.io.wavfile.read(out)
    _, ref = scipy.io.wavfile.read(want)
    assert sr == 16000 and got.shape == ref.shape == (len(jax_wav),)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_server_serves_tacotron2_serially(pair_dir, jax_wav):
    """``--max_batch 4`` with a vocoder: the batcher refuses a mel model,
    as the JAX batcher does, the server says it serves serially, and
    ``/api/tts`` answers with the synthesizer's audio."""
    args = build_parser().parse_args([
        "--model_path", str(pair_dir / "t2" / "model_torch.pt"), "--config_path",
        str(pair_dir / "t2" / "config.json"), "--vocoder_path",
        str(pair_dir / "voc" / "model_torch.pt"), "--vocoder_config_path",
        str(pair_dir / "voc" / "config.json"), "--max_batch", "4", "--port", "0",
        "--device", "cpu"])
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        srv = server_from_args(args)
    assert "serving serially" in said.getvalue() and srv.batcher is None
    no_vocoder = Synthesizer(tts_checkpoint=str(pair_dir / "t2" / "model_torch.pt"),
                             tts_config_path=str(pair_dir / "t2" / "config.json"), device="cpu")
    with pytest.raises(ValueError, match="emits_waveform"):
        DynamicBatcher(no_vocoder, max_batch=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?" + urllib.parse.urlencode(
            {"text": TEXT})
        with urllib.request.urlopen(url, timeout=120) as r:
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(r.read()))
    finally:
        close_server(srv)
    want = (jax_wav * (32767 / max(0.01, float(np.abs(jax_wav).max())))).astype(np.int16)
    assert sr == 16000 and pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# the zoo by name, offline
# ---------------------------------------------------------------------------

# the Tacotron2 entries the port runs, each with its catalog's default vocoder
ZOO = {
    DDC: HIFIGAN_V2,
    "tts_models/en/ljspeech/tacotron2-DCA": "vocoder_models/en/ljspeech/multiband-melgan",
    "tts_models/es/mai/tacotron2-DDC": "vocoder_models/universal/libri-tts/fullband-melgan",
    "tts_models/fr/mai/tacotron2-DDC": "vocoder_models/universal/libri-tts/fullband-melgan",
    "tts_models/de/thorsten/tacotron2-DCA": "vocoder_models/de/thorsten/fullband-melgan",
    "tts_models/de/thorsten/tacotron2-DDC": "vocoder_models/de/thorsten/hifigan_v1",
    "tts_models/ja/kokoro/tacotron2-DDC": "vocoder_models/ja/kokoro/hifigan_v1",
}
MELGANS = {"multiband-melgan": ("multiband_melgan", [4, 4]),
           "fullband-melgan": ("fullband_melgan", [8, 8])}


def zoo_dir(home, name):
    return home / "tts_tpu" / name.replace("/", "--")


def write_melgan(d, kind):
    """A tiny MelGAN-family generator (hop 64) drawn from a seed, in the
    reference layout with its ``config.json``."""
    d.mkdir(parents=True)
    model, ups = MELGANS[kind]
    config = config_from_dict({"model": model, "audio": dict(AUDIO)})
    config.generator_model_params = {"upsample_factors": ups, "num_res_blocks": 2,
                                     "base_channels": 32}
    gen = make_generator_from_config(config)
    draw = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.randn(p.shape, generator=draw) / max(p[0].numel(), 1) ** 0.5)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_melgan_state(gen.state_dict()).items()}},
               d / "model_file.pth")
    write_json(d / "config.json", config.to_dict())


@pytest.fixture(scope="module")
def zoo_home(pair_dir, tmp_path_factory):
    """A ``TTS_HOME`` holding, in the reference layout (``model_file.pth``,
    ``config.json``), the tiny Tacotron2 under each DDC entry, a tiny DCA
    one under each DCA entry, and each entry's default vocoder: the tiny
    HiFiGAN, or a tiny Multiband- or Fullband-MelGAN."""
    home = tmp_path_factory.mktemp("tts_home")
    write_tacotron2(home / "dca", seed=3, attention_type="dynamic_convolution",
                    location_attn=False)
    for name, vocoder in ZOO.items():
        shutil.copytree(home / ("dca" if "DCA" in name else pair_dir / "t2"),
                        zoo_dir(home, name))
        v = zoo_dir(home, vocoder)
        if v.exists():
            continue
        if "hifigan" in vocoder:
            shutil.copytree(pair_dir / "voc", v)
        else:
            write_melgan(v, vocoder.rsplit("/", 1)[1])
    for d in (home / "tts_tpu").iterdir():
        for name in ("model.msgpack", "model_torch.pt"):
            (d / name).unlink(missing_ok=True)
    return home


@pytest.fixture
def offline(zoo_home, monkeypatch):
    monkeypatch.setenv("TTS_HOME", str(zoo_home))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return zoo_home


def test_ddc_by_name_speaks_like_the_same_files_by_path(offline, tmp_path):
    """``TTS(model_name=DDC)`` loads the model and ``hifigan_v2`` from
    their directories, fetching nothing; the audio equals the same files
    loaded by path, and ``tts --model_name`` writes it within one int16
    step."""
    tts = TTS(model_name=DDC, device="cpu")
    assert tts.synthesizer.vocoder_model is not None and tts.synthesizer.from_file
    by_name = np.asarray(tts.tts(TEXT), np.float32)
    t2, voc = zoo_dir(offline, DDC), zoo_dir(offline, HIFIGAN_V2)
    by_path = TTS(model_path=str(t2 / "model_file.pth"), config_path=str(t2 / "config.json"),
                  vocoder_path=str(voc / "model_file.pth"),
                  vocoder_config_path=str(voc / "config.json"), device="cpu")
    np.testing.assert_array_equal(by_name, np.asarray(by_path.tts(TEXT), np.float32))
    port_cli(["--text", TEXT, "--model_name", DDC, "--out_path", str(tmp_path / "cli.wav"),
              "--device", "cpu"])
    _, pcm = scipy.io.wavfile.read(tmp_path / "cli.wav")
    want = (by_name * (32767 / max(0.01, float(np.abs(by_name).max())))).astype(np.int16)
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("name", list(ZOO))
def test_tacotron2_entries_load_with_their_vocoders(name, offline):
    """Each Tacotron2 entry the port runs loads by name with its catalog's
    default vocoder and speaks."""
    tts = TTS(model_name=name, device="cpu")
    synth = tts.synthesizer
    family = ZOO[name].rsplit("/", 1)[1].split("_")[0].replace("-", "_")
    assert synth.tts_config.model == "tacotron2"
    assert synth.vocoder_config.generator_model.startswith(family)
    assert synth.tts_config.attention_type == ("dynamic_convolution" if "DCA" in name
                                               else "original")
    wav = np.asarray(tts.tts("Be a voice."), np.float32)
    assert wav.shape[0] > SENTENCE_GAP and np.isfinite(wav).all() and np.abs(wav).max() > 0
