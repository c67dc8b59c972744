"""Voice cloning through a speaker encoder (YourTTS's path) and FastPitch
with HiFiGAN through the port's user surfaces, against the JAX package, on
the CPU: the ``Synthesizer``'s ``encoder_checkpoint`` and ``speaker_wav``,
``TTS(encoder_path=...)``, the ``tts`` command line's ``--encoder_path``,
the server's ``/api/tts?speaker_wav=``, the zoo's ``your_tts`` and
``fast_pitch`` by name, and FastPitch's mel through the vocoder bridge.

A tiny d-vector VITS (``test_torch_multispeaker.tiny_jax_multi``, 24-wide
d-vectors, two speakers in a ``speakers.json`` of non-unit vectors, both
noise scales 0 so that each package may draw its own noise) stands for
YourTTS. Its encoder for the comparisons with the JAX package is the LSTM
encoder of ``test_torch_speaker_encoder`` (24-wide d-vectors), written as
the JAX package's ``.msgpack`` and the reference's ``model_se.pth.tar``
with ``config_se.json``; the JAX wrapper builds a ResNet with group norms,
which no converted checkpoint fits, and a ResNet with ``log_input`` gives
NaN there (F21). The port's surfaces clone with the recipe's encoder, an
SE-ResNet34 with ``log_input`` (16 mels, random weights).
A tiny FastPitch (``test_torch_forward_tts``, 16 mels) and the tiny HiFiGAN
of ``test_torch_tacotron2_slice`` (16 kHz, hop 64) make the mel pair.
Waveforms agree within 1e-5; files written by the command line within one
int16 step of the API's.

Divergences from the JAX package, each named in its test:

* F22: a ``speaker_wav`` with no encoder loaded raises, naming
  ``--encoder_path``; the JAX ``Synthesizer`` decodes it with no speaker;
* F23: the zoo's ``your_tts`` directory ships its encoder, which the port's
  manager points the config at and the ``Synthesizer`` loads; the JAX
  package loads none;
* F26: the port L2-normalises d-vectors, as the reference VITS does; the
  JAX package feeds a speaker's mean d-vector as it is.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import json
import shutil
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_forward_tts import draw_params
from test_torch_forward_tts import small_config as forward_config
from test_torch_multispeaker import CASES, D_VECTOR_DIM, RECIPE, tiny_jax_multi, write_d_vectors
from test_torch_multispeaker import port_of as vits_port_of
from test_torch_speaker_encoder import LSTM, LSTM_AUDIO, encoder_config, jax_module
from test_torch_speaker_encoder import jax_params as encoder_params
from test_torch_tacotron2_slice import AUDIO, write_hifigan, write_json

from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.encoder.configs import SpeakerEncoderConfig as JaxSpeakerEncoderConfig
from tts_tpu.models.forward_tts import ForwardTTS as JaxForwardTTS
from tts_tpu.models.forward_tts import config as jax_forward_config
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.config.shared import BaseAudioConfig
from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig
from tts_tpu_torch.encoder.model import SpeakerEncoder
from tts_tpu_torch.models.forward_tts import FastPitchConfig, ForwardTTS
from tts_tpu_torch.models.forward_tts import config as port_forward_config
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.utils.convert import (
    forward_tts_from_jax_params,
    reference_forward_tts_state,
    reference_speaker_encoder_state,
    reference_vits_state,
    speaker_encoder_from_jax_params,
)
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

ATOL = 1e-5
TEXT = "Be a voice, not an echo."
ENCODER_AUDIO = dict(sample_rate=16000, fft_size=512, win_length=400, hop_length=160,
                     num_mels=16)
ENCODER = {"model_name": "resnet", "input_dim": 16, "proj_dim": D_VECTOR_DIM,
           "log_input": True}  # the recipe's ResNet at 16 mels
LSTM_ENCODER = dict(LSTM, proj_dim=D_VECTOR_DIM)
YOURTTS = "tts_models/multilingual/multi-dataset/your_tts"
VCTK_FAST_PITCH = "tts_models/en/vctk/fast_pitch"
TRAINER = "/home/trainer/yourtts"  # where a published config's encoder paths point


def write_clip(path, seconds=1.0, seed=0, sr=22050):
    wav = 0.1 * np.random.RandomState(seed).randn(int(seconds * sr))
    scipy.io.wavfile.write(path, sr, (wav * 32767).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module")
def yourtts_dir(tmp_path_factory):
    """``vits/``: the tiny d-vector VITS as ``model.msgpack``,
    ``model_torch.pt`` and the reference's ``model_file.pth`` (with a
    ``speaker_encoder.*`` copy, as YourTTS's carries its loss encoder);
    ``jax_se/`` and ``se/``: the LSTM encoder for the JAX package and in the
    reference layout (``model_se.pth.tar``, ``config_se.json``); ``se_log/``:
    the ResNet with ``log_input``; two 22.05 kHz clips."""
    d = tmp_path_factory.mktemp("yourtts")
    (d / "vits").mkdir()
    speakers = write_d_vectors(d / "vits" / "speakers.json", ["p225", "p226"])
    jm, params = tiny_jax_multi(
        seed=5, config_kw=dict(RECIPE, use_d_vector_file=True, d_vector_dim=D_VECTOR_DIM,
                               d_vector_file=speakers), num_chars=100,
        inference_noise_scale=0.0, inference_noise_scale_dp=0.0, **CASES["d_vectors"])
    save_checkpoint(str(d / "vits" / "model.msgpack"), params, config=jm.config)
    write_json(d / "vits" / "config.json", jm.config.to_dict())
    state = vits_port_of(jm, params).module.state_dict()
    torch.save(state, d / "vits" / "model_torch.pt")

    eparams = encoder_params(jax_module(LSTM_ENCODER), seed=6)
    (d / "jax_se").mkdir()
    jax_cfg = encoder_config(JaxSpeakerEncoderConfig, LSTM_ENCODER, LSTM_AUDIO)
    save_checkpoint(str(d / "jax_se" / "encoder.msgpack"), eparams, config=jax_cfg)
    write_json(d / "jax_se" / "config.json", jax_cfg.to_dict())
    resnet_config = encoder_config(SpeakerEncoderConfig, ENCODER, ENCODER_AUDIO)
    resnet = SpeakerEncoder(resnet_config).init_params(seed=6, device="cpu").module.state_dict()
    for name, config, weights in (
            ("se", encoder_config(SpeakerEncoderConfig, LSTM_ENCODER, LSTM_AUDIO),
             speaker_encoder_from_jax_params(eparams)),
            ("se_log", resnet_config, resnet)):
        (d / name).mkdir()
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              reference_speaker_encoder_state(weights).items()}},
                   d / name / "model_se.pth.tar")
        write_json(d / name / "config_se.json", config.to_dict())
    se_state = reference_speaker_encoder_state(resnet)
    reference = {k: torch.from_numpy(v) for k, v in reference_vits_state(state).items()}
    reference.update({"speaker_encoder." + k: torch.from_numpy(v) for k, v in se_state.items()})
    torch.save({"model": reference}, d / "vits" / "model_file.pth")
    write_clip(d / "ref.wav", seed=1)
    write_clip(d / "other.wav", seed=2)
    return d


def port_synth(d, encoder="se", weights="model_torch.pt"):
    kw = {}
    if encoder:
        kw = dict(encoder_checkpoint=str(d / encoder / "model_se.pth.tar"),
                  encoder_config=str(d / encoder / "config_se.json"))
    return Synthesizer(tts_checkpoint=str(d / "vits" / weights),
                       tts_config_path=str(d / "vits" / "config.json"), device="cpu", **kw)


def jax_synth(d, encoder=True):
    kw = dict(encoder_checkpoint=str(d / "jax_se" / "encoder.msgpack"),
              encoder_config=str(d / "jax_se" / "config.json")) if encoder else {}
    return JaxSynthesizer(tts_checkpoint=str(d / "vits" / "model.msgpack"),
                          tts_config_path=str(d / "vits" / "config.json"),
                          use_griffin_lim=False, **kw)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs diff {err}"


def _pcm(wav):
    wav = np.asarray(wav, np.float32)
    return (wav * (32767 / max(0.01, float(np.abs(wav).max())))).astype(np.int16)


# ---------------------------------------------------------------------------
# voice cloning
# ---------------------------------------------------------------------------


def test_synthesizer_clones_a_voice_like_jax(yourtts_dir):
    """``Synthesizer(encoder_checkpoint=...)`` with ``speaker_wav``: the
    clip resampled to 16 kHz, its d-vector from the encoder, the VITS decode
    on it, against the JAX ``Synthesizer`` given the same encoder, within
    1e-5; the reference-layout files (the YourTTS checkpoint's
    ``speaker_encoder.*`` dropped) speak the same, and another clip speaks
    otherwise."""
    d = yourtts_dir
    want = jax_synth(d).tts(TEXT, speaker_wav=str(d / "ref.wav"))
    got = port_synth(d).tts(TEXT, speaker_wav=str(d / "ref.wav"))
    _close(got, want)
    reference = port_synth(d, weights="model_file.pth")
    np.testing.assert_array_equal(reference.tts(TEXT, speaker_wav=str(d / "ref.wav")), got)
    other = reference.tts(TEXT, speaker_wav=str(d / "other.wav"))
    n = min(len(got), len(other)) - SENTENCE_GAP
    assert np.abs(np.asarray(other[:n]) - np.asarray(got[:n])).max() > 1e-3


def test_f22_speaker_wav_without_an_encoder(yourtts_dir):
    """F22: with no encoder, ``TTS.tts(speaker_wav=...)`` raises naming
    ``--encoder_path`` and ``encoder_path=``; the JAX ``Synthesizer``
    resolves the same request to no speaker and no d-vector, and decodes it
    unconditioned."""
    d = yourtts_dir
    tts = TTS(model_path=str(d / "vits" / "model_torch.pt"),
              config_path=str(d / "vits" / "config.json"), device="cpu")
    with pytest.raises(ValueError, match="--encoder_path.*encoder_path="):
        tts.tts(TEXT, speaker_wav=str(d / "ref.wav"))
    assert jax_synth(d, encoder=False)._resolve_speaker(None, str(d / "ref.wav")) == (None, None)


def test_f26_d_vectors_are_normalised(yourtts_dir):
    """F26: a speaker's mean d-vector (``speakers.json``, not of unit
    length) conditions the port's VITS L2-normalised: through the
    ``Synthesizer`` it speaks as the JAX ``Synthesizer`` fed the normalised
    vector, where the JAX one fed the raw vector (its own path for a named
    speaker) speaks otherwise; voice conversion normalises both speakers'
    d-vectors too."""
    d = yourtts_dir
    synth = port_synth(d, encoder=None)
    _, raw = synth._resolve_speaker("p226")
    assert abs(float(np.linalg.norm(raw)) - 1) > 0.1
    unit = raw / np.linalg.norm(raw)
    jm = jax_synth(d, encoder=False)
    named = np.asarray(jm.tts(TEXT, speaker_name="p226"), np.float32)
    jm._resolve_speaker = lambda name, wav: (None, unit)
    want = np.asarray(jm.tts(TEXT, speaker_name="p226"), np.float32)
    _close(synth.tts(TEXT, speaker_name="p226"), want)
    n = min(len(named), len(want)) - SENTENCE_GAP
    assert named.shape != want.shape or np.abs(named[:n] - want[:n]).max() > 1e-3

    model = synth.tts_model
    y = np.abs(np.random.RandomState(3).randn(1, 30, model.args.out_channels)).astype(np.float32)
    _, other = synth._resolve_speaker("p225")
    with torch.no_grad():
        got, same = (model.voice_conversion(torch.from_numpy(y), torch.tensor([30]),
                                            torch.from_numpy(src[None]),
                                            torch.from_numpy(tgt[None]))
                     for src, tgt in ((other, raw), (other / np.linalg.norm(other), unit)))
    torch.testing.assert_close(got, same, rtol=0, atol=1e-6)


def test_cli_and_server_clone_with_a_log_input_encoder(yourtts_dir, tmp_path):
    """With a ``log_input`` ResNet (the recipe's; F21 would give NaN in the
    JAX package) the d-vector is finite; ``tts --encoder_path
    --encoder_config_path --speaker_wav`` writes ``TTS.tts_to_file``'s
    samples within one int16 step; the server with ``--max_batch 4``
    answers ``/api/tts?speaker_wav=`` on the serial path (its batcher
    dispatches nothing) with the synthesizer's audio."""
    d = yourtts_dir
    model = ["--model_path", str(d / "vits" / "model_torch.pt"), "--config_path",
             str(d / "vits" / "config.json")]
    encoder = ["--encoder_path", str(d / "se_log" / "model_se.pth.tar"),
               "--encoder_config_path", str(d / "se_log" / "config_se.json")]
    tts = TTS(model_path=model[1], config_path=model[3], encoder_path=encoder[1],
              encoder_config_path=encoder[3], device="cpu")
    sm = tts.synthesizer.tts_model.speaker_manager
    assert sm.encoder.module.log_input
    assert np.isfinite(sm.compute_embedding_from_clip(str(d / "ref.wav"))).all()
    api = tts.tts_to_file(TEXT, speaker_wav=str(d / "ref.wav"), file_path=str(tmp_path / "a.wav"))
    port_cli(["--text", TEXT, "--speaker_wav", str(d / "ref.wav"), "--out_path",
              str(tmp_path / "cli.wav"), "--device", "cpu"] + model + encoder)
    (_, want), (_, got) = (scipy.io.wavfile.read(p) for p in (api, tmp_path / "cli.wav"))
    assert got.shape == want.shape and np.abs(got.astype(np.int32) - want).max() <= 1

    srv = server_from_args(build_parser().parse_args(
        model + encoder + ["--max_batch", "4", "--port", "0", "--device", "cpu"]))
    dispatched = []
    real = srv.batcher._dispatch
    srv.batcher._dispatch = lambda batch: dispatched.append(len(batch)) or real(batch)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?" + urllib.parse.urlencode(
            {"text": TEXT, "speaker_wav": str(d / "ref.wav")})
        with urllib.request.urlopen(url, timeout=120) as r:
            pcm = scipy.io.wavfile.read(io.BytesIO(r.read()))[1]
    finally:
        close_server(srv)
    assert dispatched == []
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.fixture
def offline(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return tmp_path / "home" / "tts_tpu"


def test_f23_your_tts_by_zoo_name_loads_its_encoder(yourtts_dir, offline):
    """F23: ``your_tts`` by name from a reference-layout directory (its
    ``model_file.pth`` with ``speaker_encoder.*``, ``config.json`` naming the
    trainer's files, ``speakers.json``, ``model_se.pth.tar``,
    ``config_se.json``), nothing fetched: the manager points the config's
    encoder paths at the directory's files and the ``Synthesizer`` loads
    that encoder, so ``speaker_wav`` clones as the path load with
    ``encoder_path`` does. The same files without the encoder: the config's
    paths (the trainer's disk) are neither rewritten nor opened, and
    ``speaker_wav`` raises (F22)."""
    d = yourtts_dir
    zoo = offline / YOURTTS.replace("/", "--")
    zoo.mkdir(parents=True)
    shutil.copy(d / "vits" / "model_file.pth", zoo)
    shutil.copy(d / "vits" / "speakers.json", zoo)
    for f in ("model_se.pth.tar", "config_se.json"):
        shutil.copy(d / "se_log" / f, zoo)
    config = json.loads((d / "vits" / "config.json").read_text())
    config["d_vector_file"] = config["model_args"]["d_vector_file"] = f"{TRAINER}/speakers.json"
    config["model_args"].update(use_speaker_encoder_as_loss=True,
                                speaker_encoder_model_path=f"{TRAINER}/model_se.pth.tar",
                                speaker_encoder_config_path=f"{TRAINER}/config_se.json")
    write_json(zoo / "config.json", config)
    by_name = TTS(model_name=YOURTTS, device="cpu")
    args = json.loads((zoo / "config.json").read_text())["model_args"]
    assert args["speaker_encoder_model_path"] == str(zoo / "model_se.pth.tar")
    assert args["speaker_encoder_config_path"] == str(zoo / "config_se.json")
    by_path = TTS(model_path=str(zoo / "model_file.pth"), config_path=str(zoo / "config.json"),
                  encoder_path=str(zoo / "model_se.pth.tar"),
                  encoder_config_path=str(zoo / "config_se.json"), device="cpu")
    got = by_name.tts(TEXT, speaker_wav=str(d / "ref.wav"))
    np.testing.assert_array_equal(got, by_path.tts(TEXT, speaker_wav=str(d / "ref.wav")))
    assert np.isfinite(got).all() and np.abs(got).max() > 0

    bare = offline / "bare"
    bare.mkdir()
    shutil.copy(d / "vits" / "model_file.pth", bare)
    config = json.loads((zoo / "config.json").read_text())
    config["model_args"].update(speaker_encoder_model_path=f"{TRAINER}/model_se.pth.tar",
                                speaker_encoder_config_path=f"{TRAINER}/config_se.json")
    write_json(bare / "config.json", config)
    synth = Synthesizer(tts_checkpoint=str(bare / "model_file.pth"),
                        tts_config_path=str(bare / "config.json"), device="cpu")
    assert synth.tts_model.speaker_manager.encoder is None
    assert synth.tts_config.model_args.speaker_encoder_model_path.startswith(TRAINER)
    with pytest.raises(ValueError, match="F22"):
        synth.tts(TEXT, speaker_wav=str(d / "ref.wav"))


# ---------------------------------------------------------------------------
# FastPitch with HiFiGAN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fast_pitch_dir(tmp_path_factory):
    """``fp/``: the tiny FastPitch (graphemes with ``english_cleaners``) as
    ``model.msgpack``, ``model_torch.pt`` and the reference's
    ``model_file.pth``; ``voc/``: the tiny HiFiGAN."""
    d = tmp_path_factory.mktemp("fast_pitch")
    (d / "fp").mkdir()
    config = forward_config(jax_forward_config, "fast_pitch", num_chars=None)
    config.audio = JaxAudioConfig(**AUDIO)
    config.text_cleaner, config.use_phonemes = "english_cleaners", False
    jm = JaxForwardTTS.init_from_config(config)
    params = draw_params(jm, seed=1)
    save_checkpoint(str(d / "fp" / "model.msgpack"), params, config=jm.config)
    write_json(d / "fp" / "config.json", jm.config.to_dict())
    port = ForwardTTS(FastPitchConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(forward_tts_from_jax_params(params))
    state = port.module.state_dict()
    torch.save(state, d / "fp" / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_forward_tts_state(
        state, port.module.pos_encoder.pe).items()}}, d / "fp" / "model_file.pth")
    write_hifigan(d / "voc")
    return d


def fast_pitch_args(d, weights="model_torch.pt"):
    return ["--model_path", str(d / "fp" / weights), "--config_path", str(d / "fp" / "config.json"),
            "--vocoder_path", str(d / "voc" / weights), "--vocoder_config_path",
            str(d / "voc" / "config.json")]


def test_fast_pitch_with_hifigan_through_the_surfaces(fast_pitch_dir, tmp_path):
    """Two sentences through the JAX ``Synthesizer`` and the port's (the mel
    cut at ``y_lengths``, vocoded through the bridge, trimmed): within
    1e-5, and the reference-layout files speak the same; ``TTS(model_path,
    vocoder_path)`` likewise; ``tts --vocoder_path`` within one int16 step;
    the server with ``--max_batch 4`` says it serves serially and answers
    ``/api/tts`` with the same samples."""
    d = fast_pitch_dir
    text = TEXT + " Prior to November 22, 1963."
    want = JaxSynthesizer(tts_checkpoint=str(d / "fp" / "model.msgpack"),
                          tts_config_path=str(d / "fp" / "config.json"),
                          vocoder_checkpoint=str(d / "voc" / "model.msgpack"),
                          vocoder_config=str(d / "voc" / "config.json")).tts(text)
    args = fast_pitch_args(d)
    tts = TTS(model_path=args[1], config_path=args[3], vocoder_path=args[5],
              vocoder_config_path=args[7], device="cpu")
    got = tts.tts(text)
    _close(got, want)
    assert tts.synthesizer.output_sample_rate == 16000 and np.abs(got).max() > 0.01
    reference = Synthesizer(tts_checkpoint=str(d / "fp" / "model_file.pth"),
                            tts_config_path=args[3], vocoder_checkpoint=str(d / "voc" /
                                                                            "model_file.pth"),
                            vocoder_config=args[7], device="cpu")
    np.testing.assert_array_equal(reference.tts(text), got)

    api = tts.tts_to_file(text, file_path=str(tmp_path / "api.wav"))
    port_cli(["--text", text, "--out_path", str(tmp_path / "cli.wav"), "--device", "cpu"]
             + fast_pitch_args(d, "model_file.pth"))
    (_, ref_pcm), (sr, pcm) = (scipy.io.wavfile.read(p) for p in (api, tmp_path / "cli.wav"))
    assert sr == 16000 and pcm.shape == ref_pcm.shape
    assert np.abs(pcm.astype(np.int32) - ref_pcm).max() <= 1

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        srv = server_from_args(build_parser().parse_args(
            args + ["--max_batch", "4", "--port", "0", "--device", "cpu"]))
    assert "serving serially" in said.getvalue() and srv.batcher is None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?" + urllib.parse.urlencode(
            {"text": text})
        with urllib.request.urlopen(url, timeout=120) as r:
            served = scipy.io.wavfile.read(io.BytesIO(r.read()))[1]
    finally:
        close_server(srv)
    assert np.abs(served.astype(np.int32) - _pcm(want)).max() <= 1


def test_vctk_fast_pitch_by_zoo_name_equals_the_path_load(offline, tmp_path):
    """``tts_models/en/vctk/fast_pitch`` by name (no default vocoder:
    Griffin-Lim) from a reference-layout directory whose config sets the
    VCTK recipe's top-level ``use_speaker_embedding`` and names the
    trainer's ``speakers.json``: the file is found in the directory, each
    speaker reaches the model (F24), and the audio equals the path load
    after one ``np.random.seed`` each (Griffin-Lim's first phases)."""
    zoo = offline / VCTK_FAST_PITCH.replace("/", "--")
    zoo.mkdir(parents=True)
    write_json(zoo / "speakers.json", {"p225": 0, "p226": 1, "p227": 2})
    config = forward_config(port_forward_config, "fast_pitch", num_chars=None)
    config.audio = BaseAudioConfig(**dict(AUDIO, griffin_lim_iters=8))
    config.text_cleaner, config.use_phonemes = "english_cleaners", False
    config.use_speaker_embedding, config.speakers_file = True, str(zoo / "speakers.json")
    model = ForwardTTS.init_from_config(config).init_params(seed=2, device="cpu")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_forward_tts_state(
        model.module.state_dict(), model.module.pos_encoder.pe).items()}},
        zoo / "model_file.pth")
    saved = config.to_dict()
    saved["speakers_file"] = f"{TRAINER}/speakers.json"
    write_json(zoo / "config.json", saved)

    by_name = TTS(model_name=VCTK_FAST_PITCH, device="cpu")
    assert by_name.speakers == ["p225", "p226", "p227"]
    by_path = TTS(model_path=str(zoo / "model_file.pth"), config_path=str(zoo / "config.json"),
                  device="cpu")
    wavs = {}
    for name, tts, speaker in (("name", by_name, "p226"), ("path", by_path, "p226"),
                               ("other", by_name, "p225")):
        np.random.seed(0)
        wavs[name] = np.asarray(tts.tts(TEXT, speaker=speaker), np.float32)
    np.testing.assert_array_equal(wavs["name"], wavs["path"])
    n = min(len(wavs["name"]), len(wavs["other"])) - SENTENCE_GAP
    assert np.abs(wavs["name"][:n] - wavs["other"][:n]).max() > 1e-3
