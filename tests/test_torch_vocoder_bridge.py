"""GlowTTS with a vocoder through the port's user surfaces, against the JAX
package, on the CPU: the ``Synthesizer``'s mel → vocoder bridge, Griffin-Lim,
``TTS(vocoder_path=...)``, the ``tts`` command line's ``--vocoder_path``,
``--vocoder_config_path`` and ``--vocoder_name``, the server's vocoder flags
with the batcher's refusal, and the zoo by name with a default vocoder.

One tiny GlowTTS (``test_torch_glow_tts.tiny_glow_kw``: graphemes with
``english_cleaners``, 16 mels at 16 kHz, hop 64) and one tiny
Multiband-MelGAN (32 channels, upsampling [4, 4], 4 bands) are written as
the JAX package's ``.msgpack`` checkpoints, the port's ``model_torch.pt``
and the reference layout's ``model_file.pth``, each beside its
``config.json``. The same text goes through the JAX ``Synthesizer`` and the
port's; the waveforms, each sentence trimmed at its endpoint as both
packages trim a model loaded from a file, agree within 1e-5. A second pair of
configs makes the bridge do work: mean-var statistics on the TTS side,
range normalisation and 22.05 kHz on the vocoder's, so that the mel is
rescaled and resampled in time.

Divergence from the JAX package, named in its test (ROADMAP.md F17): the
port's zoo manager points a downloaded config's ``audio.stats_path`` at the
directory's ``scale_stats.npy``, as the reference does; the JAX copy leaves
the trainer's path, which its ``AudioProcessor`` then fails to read.
"""

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
from test_torch_glow_tts import as_glow_params, drawn_params, tiny_glow_kw

from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.models.glow_tts.config import GlowTTSConfig as JaxGlowTTSConfig
from tts_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu.vocoder.configs import MultibandMelganConfig as JaxMultibandMelganConfig
from tts_tpu.vocoder.utils import make_generator_from_config as jax_make_generator
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.glow_tts import GlowTTS, GlowTTSConfig
from tts_tpu_torch.server.batching import DynamicBatcher
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.utils.convert import (
    glow_tts_from_jax_params,
    melgan_from_jax_params,
    reference_glow_tts_state,
    reference_melgan_state,
)
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer
from tts_tpu_torch.vocoder.configs import MultibandMelganConfig
from tts_tpu_torch.vocoder.models.melgan_generator import MultibandMelganGenerator

ATOL = 1e-5
TEXT = "Be a voice, not an echo. Prior to November 22, 1963."
# trim_db 3: the tiny vocoder's audio (peak ~0.65) stays below -3 dB, so each
# sentence is cut at its first 0.8 s window, and the trim is exercised
AUDIO = dict(sample_rate=16000, fft_size=256, win_length=256, hop_length=64, num_mels=16,
             griffin_lim_iters=30, trim_db=3)
GLOW = "tts_models/en/ljspeech/glow-tts"
MBMELGAN = "vocoder_models/en/ljspeech/multiband-melgan"
FOREIGN_STATS = "/home/trainer/ljspeech-mbmelgan/scale_stats.npy"


def _stats(path, audio: dict, seed: int):
    """A ``scale_stats.npy`` as the reference's ``compute_statistics``
    writes it, for ``audio``."""
    rs = np.random.RandomState(seed)
    n, lin = audio["num_mels"], audio["fft_size"] // 2 + 1
    np.save(path, {"mel_mean": rs.randn(n) * 5 - 40, "mel_std": rs.rand(n) * 5 + 10,
                   "linear_mean": rs.randn(lin), "linear_std": rs.rand(lin) + 1,
                   "audio_config": dict(audio)}, allow_pickle=True)


def write_pair(d, tts_audio=None, voc_audio=None, seed=0):
    """The tiny GlowTTS and Multiband-MelGAN, each in the JAX, port and
    reference layouts with its ``config.json``, under ``d/glow`` and
    ``d/voc``. Returns the two port configs."""
    glow_dir, voc_dir = d / "glow", d / "voc"
    glow_dir.mkdir()
    voc_dir.mkdir()
    config = JaxGlowTTSConfig(**tiny_glow_kw(), text_cleaner="english_cleaners",
                              use_phonemes=False,
                              audio=JaxAudioConfig(**(tts_audio or AUDIO)))
    jm = JaxGlowTTS.init_from_config(config)
    x = jnp.zeros((1, 16), jnp.int32)
    y = jnp.zeros((1, 32, 16), jnp.float32)
    params = as_glow_params(drawn_params(
        lambda k: jm.module.init(k, x, jnp.array([16]), y, jnp.array([32])),
        jax.random.PRNGKey(0), seed=seed), seed)
    save_checkpoint(str(glow_dir / "model.msgpack"), params, config=jm.config)
    glow_config = GlowTTSConfig.from_dict(jm.config.to_dict())
    port = GlowTTS(glow_config)
    port.load_state_dict(glow_tts_from_jax_params(params))
    torch.save(port.module.state_dict(), glow_dir / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_glow_tts_state(port.module.state_dict()).items()}},
               glow_dir / "model_file.pth")
    with open(glow_dir / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)

    vconfig = JaxMultibandMelganConfig(audio=JaxAudioConfig(**(voc_audio or AUDIO)))
    vconfig.generator_model_params = {"upsample_factors": [4, 4], "num_res_blocks": 2,
                                      "base_channels": 32}
    gen = jax_make_generator(vconfig)
    vparams = drawn_params(gen.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                           seed=seed + 1, scale=0.15)
    save_checkpoint(str(voc_dir / "model.msgpack"), vparams, config=vconfig)
    voc_config = MultibandMelganConfig.from_dict(vconfig.to_dict())
    port_gen = MultibandMelganGenerator(in_channels=16, upsample_factors=(4, 4),
                                        num_res_blocks=2, base_channels=32)
    port_gen.load_state_dict(melgan_from_jax_params(vparams), strict=True)
    torch.save(port_gen.state_dict(), voc_dir / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_melgan_state(port_gen.state_dict()).items()}},
               voc_dir / "model_file.pth")
    with open(voc_dir / "config.json", "w") as f:
        json.dump(vconfig.to_dict(), f)
    return glow_config, voc_config


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("glow_mbmelgan")
    write_pair(d)
    return d


def jax_synth(d, vocoder=True):
    kw = dict(vocoder_checkpoint=str(d / "voc" / "model.msgpack"),
              vocoder_config=str(d / "voc" / "config.json")) if vocoder else {}
    return JaxSynthesizer(tts_checkpoint=str(d / "glow" / "model.msgpack"),
                          tts_config_path=str(d / "glow" / "config.json"), **kw)


def port_synth(d, vocoder=True, weights="model_torch.pt"):
    kw = dict(vocoder_checkpoint=str(d / "voc" / weights),
              vocoder_config=str(d / "voc" / "config.json")) if vocoder else {}
    return Synthesizer(tts_checkpoint=str(d / "glow" / weights),
                       tts_config_path=str(d / "glow" / "config.json"), device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_wav(pair_dir):
    return np.asarray(jax_synth(pair_dir).tts(TEXT), np.float32)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, f"max abs diff {err}"


def test_synthesizer_with_vocoder_matches_jax(pair_dir, jax_wav):
    """Two sentences, each decoded at its frame budget, cut at
    ``y_lengths``, vocoded (the bridge is the identity here: one audio
    config), trimmed and followed by the 10000-sample gap."""
    synth = port_synth(pair_dir)
    assert synth.output_sample_rate == 16000 and synth.vocoder_ap is not None
    wav = np.asarray(synth.tts(TEXT), np.float32)
    _close(wav, jax_wav)
    assert np.all(wav[-SENTENCE_GAP:] == 0) and np.abs(wav).max() > 0.01
    synth.from_file = False  # as from a model directory: not trimmed
    assert len(synth.tts(TEXT)) > len(wav)


def test_reference_layout_files_speak_the_same(pair_dir, jax_wav):
    """The reference-layout ``model_file.pth`` pair, converted at load,
    speaks as the port's own state dicts do."""
    wav = port_synth(pair_dir, weights="model_file.pth").tts(TEXT)
    np.testing.assert_array_equal(np.asarray(wav, np.float32),
                                  np.asarray(port_synth(pair_dir).tts(TEXT), np.float32))


def test_mismatched_processors_bridge_matches_jax(tmp_path, capsys):
    """Mean-var statistics on the TTS side (16 kHz), range normalisation at
    22.05 kHz on the vocoder's: the mel is denormalised with the TTS
    processor's scaler, normalised into the vocoder's range and resampled in
    time by 22050/16000, in both packages alike."""
    tts_audio = dict(AUDIO, trim_db=45, stats_path=str(tmp_path / "scale_stats.npy"))
    _stats(tmp_path / "scale_stats.npy", tts_audio, seed=3)
    voc_audio = dict(AUDIO, sample_rate=22050, max_norm=1.0, symmetric_norm=False,
                     ref_level_db=10, min_level_db=-90)
    write_pair(tmp_path, tts_audio, voc_audio, seed=4)
    want = np.asarray(jax_synth(tmp_path).tts(TEXT), np.float32)
    synth = port_synth(tmp_path)
    assert hasattr(synth.ap, "mel_scaler") and not hasattr(synth.vocoder_ap, "mel_scaler")
    assert synth.output_sample_rate == 22050
    _close(synth.tts(TEXT), want)
    assert "interpolating tts model output" in capsys.readouterr().out


def test_griffin_lim_matches_jax(pair_dir):
    """Without a vocoder both speak through Griffin-Lim on the host, its
    first phases from numpy's global generator: the same ``np.random.seed``
    gives the same audio, within 1e-4 of a waveform that peaks near 4 (30
    iterations carry the mels' differences of 1e-7 that far)."""
    jax_s, port_s = jax_synth(pair_dir, vocoder=False), port_synth(pair_dir, vocoder=False)
    np.random.seed(0)
    want = np.asarray(jax_s.tts(TEXT), np.float32)
    np.random.seed(0)
    got = np.asarray(port_s.tts(TEXT), np.float32)
    assert port_s.output_sample_rate == 16000
    _close(got, want, 1e-4)
    no_gl = Synthesizer(tts_checkpoint=str(pair_dir / "glow" / "model_torch.pt"),
                        tts_config_path=str(pair_dir / "glow" / "config.json"), device="cpu",
                        use_griffin_lim=False)
    with pytest.raises(RuntimeError, match="No vocoder or Griffin-Lim"):
        no_gl.tts(TEXT)


def test_tts_api_with_vocoder_path(pair_dir, jax_wav, tmp_path):
    tts = TTS(model_path=str(pair_dir / "glow" / "model_torch.pt"),
              config_path=str(pair_dir / "glow" / "config.json"),
              vocoder_path=str(pair_dir / "voc" / "model_torch.pt"),
              vocoder_config_path=str(pair_dir / "voc" / "config.json"), device="cpu")
    _close(tts.tts(TEXT), jax_wav)
    sr, pcm = scipy.io.wavfile.read(tts.tts_to_file(TEXT, file_path=str(tmp_path / "a.wav")))
    assert sr == 16000 and len(pcm) == len(jax_wav)


def test_cli_vocoder_flags(pair_dir, tmp_path):
    """``--vocoder_path`` with ``--vocoder_config_path``: the file is the
    API's within one int16 step."""
    out = tmp_path / "cli.wav"
    args = ["--text", TEXT, "--model_path", str(pair_dir / "glow" / "model_file.pth"),
            "--config_path", str(pair_dir / "glow" / "config.json"), "--vocoder_path",
            str(pair_dir / "voc" / "model_file.pth"), "--vocoder_config_path",
            str(pair_dir / "voc" / "config.json"), "--out_path", str(out), "--device", "cpu"]
    port_cli(args)
    api = TTS(model_path=str(pair_dir / "glow" / "model_torch.pt"),
              config_path=str(pair_dir / "glow" / "config.json"),
              vocoder_path=str(pair_dir / "voc" / "model_torch.pt"),
              vocoder_config_path=str(pair_dir / "voc" / "config.json"), device="cpu")
    want = api.tts_to_file(TEXT, file_path=str(tmp_path / "api.wav"))
    sr, got = scipy.io.wavfile.read(out)
    _, ref = scipy.io.wavfile.read(want)
    assert sr == 16000 and got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_server_vocoder_flags_and_batcher_refusal(pair_dir, jax_wav):
    """The server's ``--vocoder_path``/``--vocoder_config_path`` with
    ``--max_batch 4``: the batcher refuses a mel → vocoder pipeline, as the
    JAX batcher does, the server says it serves serially, and ``/api/tts``
    answers with the synthesizer's audio at the vocoder's rate."""
    args = build_parser().parse_args([
        "--model_path", str(pair_dir / "glow" / "model_torch.pt"), "--config_path",
        str(pair_dir / "glow" / "config.json"), "--vocoder_path",
        str(pair_dir / "voc" / "model_torch.pt"), "--vocoder_config_path",
        str(pair_dir / "voc" / "config.json"), "--max_batch", "4", "--port", "0",
        "--device", "cpu"])
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        srv = server_from_args(args)
    assert "serving serially" in said.getvalue() and srv.batcher is None
    with pytest.raises(ValueError, match="mel→vocoder pipelines keep the serial path"):
        DynamicBatcher(port_synth(pair_dir), max_batch=4)
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


def zoo_dir(home, name):
    return home / "tts_tpu" / name.replace("/", "--")


def name_foreign_stats(config_path) -> dict:
    """Point the config's ``audio.stats_path`` where its trainer kept the
    statistics, as a published config does; returns its audio section."""
    with open(config_path) as f:
        config = json.load(f)
    config["audio"]["stats_path"] = FOREIGN_STATS
    with open(config_path, "w") as f:
        json.dump(config, f)
    return config["audio"]


@pytest.fixture(scope="module")
def zoo_home(pair_dir, tmp_path_factory):
    """A ``TTS_HOME`` holding the tiny pair as the LJSpeech GlowTTS and its
    default vocoder in the reference layout: ``model_file.pth`` and
    ``config.json`` each, the vocoder with mean-var statistics in its
    ``scale_stats.npy`` and a config naming its trainer's ``stats_path``;
    and an Italian GlowTTS without a vocoder."""
    home = tmp_path_factory.mktemp("tts_home")
    glow, voc, it = zoo_dir(home, GLOW), zoo_dir(home, MBMELGAN), zoo_dir(
        home, "tts_models/it/mai_female/glow-tts")
    shutil.copytree(pair_dir / "glow", glow)
    shutil.copytree(pair_dir / "voc", voc)
    shutil.copytree(pair_dir / "glow", it)
    for d in (glow, voc, it):
        for name in ("model.msgpack", "model_torch.pt"):
            (d / name).unlink()
    _stats(voc / "scale_stats.npy", name_foreign_stats(voc / "config.json"), seed=7)
    with open(it / "config.json") as f:
        iconfig = json.load(f)
    iconfig["text_cleaner"] = "multilingual_cleaners"
    with open(it / "config.json", "w") as f:
        json.dump(iconfig, f)
    return home


@pytest.fixture
def offline(zoo_home, monkeypatch):
    monkeypatch.setenv("TTS_HOME", str(zoo_home))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return zoo_home


def test_zoo_by_name_loads_the_default_vocoder(offline):
    """``TTS(model_name=GLOW)`` loads the model and its ``default_vocoder``
    from their directories, fetching nothing; the audio equals the same
    files loaded by path, and ``tts --model_name`` writes the same file
    within one int16 step."""
    tts = TTS(model_name=GLOW, device="cpu")
    synth = tts.synthesizer
    assert synth.vocoder_model is not None and synth.from_file
    by_name = np.asarray(tts.tts(TEXT), np.float32)
    glow, voc = zoo_dir(offline, GLOW), zoo_dir(offline, MBMELGAN)
    by_path = TTS(model_path=str(glow / "model_file.pth"), config_path=str(glow / "config.json"),
                  vocoder_path=str(voc / "model_file.pth"),
                  vocoder_config_path=str(voc / "config.json"), device="cpu")
    np.testing.assert_array_equal(by_name, np.asarray(by_path.tts(TEXT), np.float32))
    port_cli(["--text", TEXT, "--model_name", GLOW, "--out_path", str(offline / "cli.wav"),
              "--device", "cpu"])
    _, pcm = scipy.io.wavfile.read(offline / "cli.wav")
    want = (by_name * (32767 / max(0.01, float(np.abs(by_name).max())))).astype(np.int16)
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_f17_stats_path_points_at_the_download(offline, tmp_path):
    """F17: the port rewrites ``audio.stats_path`` to the directory's
    ``scale_stats.npy`` and normalises with those statistics; the JAX
    manager's ``_update_paths`` leaves the trainer's path, and its
    ``AudioProcessor`` cannot read it."""
    from tts_tpu.audio.processor import AudioProcessor as JaxAudioProcessor
    from tts_tpu.config import load_config as jax_load_config
    from tts_tpu.utils import manage as jax_manage

    voc = zoo_dir(offline, MBMELGAN)
    name_foreign_stats(voc / "config.json")
    theirs = tmp_path / "jax_copy"
    shutil.copytree(voc, theirs)
    jax_manage.ModelManager._update_paths(str(theirs), str(theirs / "config.json"))
    config = jax_load_config(str(theirs / "config.json"))
    assert config.audio.stats_path == FOREIGN_STATS
    with pytest.raises(FileNotFoundError):
        JaxAudioProcessor.init_from_config(config, verbose=False)

    tts = TTS(model_name=GLOW, device="cpu")
    with open(voc / "config.json") as f:
        assert json.load(f)["audio"]["stats_path"] == str(voc / "scale_stats.npy")
    stats = np.load(voc / "scale_stats.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(tts.synthesizer.vocoder_ap.mel_scaler.mean_, stats["mel_mean"])


def test_zoo_entry_without_a_vocoder_speaks_through_griffin_lim(offline):
    """An entry with no ``default_vocoder`` (the Italian GlowTTS) loads and
    speaks through Griffin-Lim."""
    tts = TTS(model_name="tts_models/it/mai_female/glow-tts", device="cpu")
    assert tts.synthesizer.vocoder_model is None
    np.random.seed(0)
    wav = np.asarray(tts.tts("Essere una voce, non un'eco."), np.float32)
    assert wav.shape[0] > SENTENCE_GAP and np.isfinite(wav).all()


@pytest.mark.parametrize("change,missing", [
    ({"text_cleaner": "persian_cleaners"}, "persian_cleaners"),
    ({"use_phonemes": True, "phoneme_language": "xx-klingon", "phonemizer": None},
     "xx-klingon"),
])
def test_missing_text_front_end_raises_at_load(offline, change, missing):
    """An entry whose cleaner or phonemizer the port lacks raises
    ``NotImplementedError`` naming it when it loads, not inside the
    tokenizer at the first sentence."""
    d = zoo_dir(offline, "tts_models/fa/custom/glow-tts")
    shutil.copytree(zoo_dir(offline, GLOW), d)
    try:
        with open(d / "config.json") as f:
            config = json.load(f)
        config.update(change)
        with open(d / "config.json", "w") as f:
            json.dump(config, f)
        with pytest.raises(NotImplementedError, match=missing):
            TTS(model_name="tts_models/fa/custom/glow-tts", device="cpu")
    finally:
        shutil.rmtree(d)


def test_vocoder_names_resolve_through_the_zoo(offline, tmp_path):
    """``--vocoder_name`` loads a zoo vocoder in place of the default; a
    vocoder given as the model raises ``ValueError``; Tacotron2-DCA still
    raises for its item although its vocoder loads."""
    out = tmp_path / "named.wav"
    port_cli(["--text", TEXT, "--model_name", GLOW, "--vocoder_name", MBMELGAN,
              "--out_path", str(out), "--device", "cpu"])
    assert scipy.io.wavfile.read(out)[0] == 16000
    with pytest.raises(ValueError, match="is a vocoder"):
        TTS(model_name=MBMELGAN, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 14"):
        TTS(model_name="tts_models/en/ljspeech/tacotron2-DCA", device="cpu")
