"""Tacotron2 with ParallelWaveGAN, UnivNet, WaveGrad and WaveRNN through the
port's user surfaces, against the JAX package, on the CPU: the
``Synthesizer``'s mel → vocoder bridge, ``TTS(model_path=...,
vocoder_path=...)``, the ``tts`` command line's ``--vocoder_path``, the
server (which serves a mel model serially), and the zoo by name: the three
Tacotron2 entries whose default vocoders these are (``en/ek1/tacotron2``
with WaveGrad, ``en/ljspeech/tacotron2-DDC_ph`` with UnivNet,
``nl/mai/tacotron2-DDC`` with ParallelWaveGAN) and the five vocoder entries.

The tiny Tacotron2 of ``test_torch_tacotron2_slice`` (16 mels at 16 kHz,
hop 64; the stopnet never fires, so a short sentence decodes its budget of
128 frames) and one tiny generator of each family (hop 64; WaveGrad's test
schedule cut to 6 steps) drawn from a seed are written as the JAX package's ``.msgpack``, the
port's ``model_torch.pt`` and the reference layout's ``model_file.pth``,
each beside its ``config.json``. UnivNet's audio runs at 22.05 kHz and
WaveRNN's at 4 kHz (hop 16, so that its sample-by-sample loop stays short),
so their bridges resample the mel in time (``interpolate_vocoder_input``);
the published configs are not in the repository, so their rates are
unchecked.

Each family's waveform through the port's ``Synthesizer`` agrees within 1e-5
with the JAX package on the same noise:

* WaveGrad and WaveRNN: the JAX ``Synthesizer`` itself (``PRNGKey(0)`` at
  each sentence), its key chain's draws handed to the port
  (``test_torch_vocoders.jax_wavegrad_draws``, ``jax_wavernn_draws``);
* ParallelWaveGAN and UnivNet: the JAX ``Synthesizer`` raises
  ``AttributeError``, as neither JAX module has an ``inference`` (ROADMAP.md
  F31), so the JAX side is its ``Synthesizer``'s mel through the JAX bridge
  and the JAX generator's ``__call__`` on the mel as the port's
  ``inference`` pads it, both packages drawing the same numpy noise.

The port's own draws (a generator on the device seeded 0 at each call)
repeat from call to call, so the API, the command line and the server give
the same audio.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
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
from test_torch_tacotron2_slice import AUDIO, write_json, write_tacotron2, zoo_dir
from test_torch_vocoders import WAVEGRAD_SCALE, jax_wavegrad_draws, jax_wavernn_draws

from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu.vocoder import configs as jax_configs
from tts_tpu.vocoder.utils import interpolate_vocoder_input as jax_interpolate
from tts_tpu.vocoder.utils import make_generator_from_config as jax_make_generator
from tts_tpu_torch.api import TTS, download_vocoder
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models import config_from_dict
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.utils import convert, synthesizer
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer
from tts_tpu_torch.vocoder.models import parallel_wavegan_generator, univnet_generator, wavernn
from tts_tpu_torch.vocoder.utils import make_generator_from_config

ATOL = 1e-5
TEXT = "Be a voice."  # 128 frames of the never-stopping Tacotron2, its smallest budget
WAVEGRAD_STEPS = 6  # the test schedule's range in 6 steps: 50 tiny eager steps take minutes
# on a loaded CPU
# family → (JAX config class, parameter field, parameters, sample rate, weight
# scale, carrier, reference writer)
FAMILIES = {
    "parallel_wavegan": ("ParallelWaveganConfig", "generator_model_params", dict(
        upsample_factors=[4, 4, 4], stacks=2, num_res_blocks=4, res_channels=8,
        gate_channels=16, skip_channels=8), 16000, 0.3,
        convert.parallel_wavegan_from_jax_params, convert.reference_parallel_wavegan_state),
    "univnet": ("UnivnetConfig", "generator_model_params", dict(
        in_channels=4, hidden_channels=8, upsample_factors=[4, 4, 4], lvc_layers_each_block=2,
        kpnet_hidden_channels=8), 22050, 0.15,  # at 0.3 a fifth of its samples saturate
        convert.univnet_from_jax_params, convert.reference_univnet_state),
    "wavegrad": ("WavegradConfig", "model_params", dict(
        y_conv_channels=8, x_conv_channels=24, dblock_out_channels=[8, 12],
        ublock_out_channels=[24, 12, 8], upsample_factors=[4, 4, 4],
        upsample_dilations=[[1, 2, 1, 2]] * 3), 16000, WAVEGRAD_SCALE,
        convert.wavegrad_from_jax_params, convert.reference_wavegrad_state),
    "wavernn": ("WavernnConfig", "model_args", dict(
        rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8, num_res_blocks=2,
        upsample_factors=[4, 4]), 4000, 0.3,
        convert.wavernn_from_jax_params, convert.reference_wavernn_state),
}
ZOO = {
    "tts_models/en/ek1/tacotron2": "vocoder_models/en/ek1/wavegrad",
    "tts_models/en/ljspeech/tacotron2-DDC_ph": "vocoder_models/en/ljspeech/univnet",
    "tts_models/nl/mai/tacotron2-DDC": "vocoder_models/nl/mai/parallel-wavegan",
}
VOCODER_ENTRIES = {
    "vocoder_models/universal/libri-tts/wavegrad": "wavegrad",
    "vocoder_models/en/ek1/wavegrad": "wavegrad",
    "vocoder_models/de/thorsten/wavegrad": "wavegrad",
    "vocoder_models/en/ljspeech/univnet": "univnet",
    "vocoder_models/nl/mai/parallel-wavegan": "parallel_wavegan",
}
FAMILY_OF = {"wavegrad": "wavegrad", "univnet": "univnet", "parallel-wavegan": "parallel_wavegan"}


def _jax_init_args(family, mel):
    if family == "wavegrad":
        return (np.zeros((1, 8 * 64, 1), np.float32), mel, np.ones(1, np.float32))
    if family == "wavernn":
        return (np.zeros((1, 8), np.float32), mel)
    if family == "univnet":
        return (mel, np.zeros((1, 8, 4), np.float32))
    return (mel, np.zeros((1, 8 * 64, 1), np.float32))


def write_vocoder(d, family, seed=1):
    """A tiny generator of ``family`` drawn from ``seed``, in the JAX
    (``model.msgpack``), port (``model_torch.pt``) and reference
    (``model_file.pth``; the GANs' under ``model_g.``) layouts with its
    ``config.json`` under ``d``."""
    kind, field, params, sr, scale, carry, writer = FAMILIES[family]
    d.mkdir(parents=True)
    audio = dict(AUDIO, sample_rate=sr)
    if family == "wavernn":  # a quarter of the rate and the hop: 16 samples a frame
        audio.update(fft_size=64, win_length=64, hop_length=16)
    vconfig = getattr(jax_configs, kind)(audio=JaxAudioConfig(**audio))
    setattr(vconfig, field, dict(params))
    if family == "wavegrad":
        vconfig.test_noise_schedule = dict(vconfig.test_noise_schedule, num_steps=WAVEGRAD_STEPS)
    gen = jax_make_generator(vconfig)
    mel = np.zeros((1, 8, AUDIO["num_mels"]), np.float32)
    vparams = drawn_params(gen.init, jax.random.PRNGKey(0), *_jax_init_args(family, mel),
                           seed=seed, scale=scale)
    save_checkpoint(str(d / "model.msgpack"), vparams, config=vconfig)
    port = make_generator_from_config(config_from_dict(vconfig.to_dict()))
    port.load_state_dict(carry(vparams), strict=True)
    torch.save(port.state_dict(), d / "model_torch.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in writer(port.state_dict()).items()}},
               d / "model_file.pth")
    write_json(d / "config.json", vconfig.to_dict())


@pytest.fixture(scope="module")
def slice_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tacotron2_vocoders")
    write_tacotron2(d / "t2")
    for family in FAMILIES:
        write_vocoder(d / family, family)
    return d


def _files(d, family, weights="model_torch.pt"):
    return dict(tts_checkpoint=str(d / "t2" / weights), tts_config_path=str(d / "t2" /
                                                                            "config.json"),
                vocoder_checkpoint=str(d / family / weights),
                vocoder_config=str(d / family / "config.json"))


def shared_noise(shape):
    """The noise both packages draw in the GAN comparisons, by shape."""
    return np.random.RandomState(0).standard_normal(shape).astype(np.float32)


def jax_gan_vocode(synth, family):
    """The JAX ``Synthesizer``'s bridge (``tts_tpu/utils/synthesizer.py:229-238``)
    and the JAX generator's ``__call__`` on the mel as the port's
    ``inference`` pads it, over :func:`shared_noise`."""
    def vocode(mel_tts_norm):
        voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(mel_tts_norm.T))
        scale = synth.vocoder_ap.sample_rate / synth.ap.sample_rate
        if scale != 1.0:
            voc_in = jax_interpolate([1, scale], voc_in)
        c = voc_in.T[None].astype(np.float32)
        m = synth.vocoder_model
        if family == "parallel_wavegan":
            p = m.inference_padding
            c = np.concatenate([c[:, :1]] * p + [c] + [c[:, -1:]] * p, axis=1)
            noise = shared_noise((1, c.shape[1] * int(np.prod(m.upsample_factors)), 1))
            wav = m.apply(synth.vocoder_params, jnp.asarray(c), jnp.asarray(noise))
        else:
            noise = shared_noise((1, c.shape[1], m.in_channels))
            wav = m.apply(synth.vocoder_params, jnp.asarray(c), x=jnp.asarray(noise))
        return np.asarray(wav, np.float32).reshape(-1)
    return vocode


_JAX_WAVS = {}


def jax_wav(d, family):
    """The JAX package's audio of ``TEXT`` with ``family``'s vocoder."""
    if family not in _JAX_WAVS:
        synth = JaxSynthesizer(**{k: v.replace("model_torch.pt", "model.msgpack")
                                  for k, v in _files(d, family).items()})
        if family in ("parallel_wavegan", "univnet"):
            with pytest.raises(AttributeError, match="inference"):  # F31
                synth.tts(TEXT)
            synth._vocode = jax_gan_vocode(synth, family)
        _JAX_WAVS[family] = np.asarray(synth.tts(TEXT), np.float32)
    return _JAX_WAVS[family]


@contextlib.contextmanager
def jax_noise_in_port(family, monkeypatch):
    """The port's vocoder draws what the JAX side draws: the shared numpy
    noise for the GANs, the JAX key chain of ``PRNGKey(0)`` for WaveGrad's
    and WaveRNN's samplers."""
    if family == "parallel_wavegan":
        def noise(self, c, generator=None):
            return torch.from_numpy(shared_noise((c.shape[0], c.shape[1] * self.hop, 1)))
        monkeypatch.setattr(parallel_wavegan_generator.ParallelWaveganGenerator, "noise", noise)
    elif family == "univnet":
        def noise(self, c, generator=None):
            return torch.from_numpy(shared_noise((c.shape[0], c.shape[1], self.in_channels)))
        monkeypatch.setattr(univnet_generator.UnivnetGenerator, "noise", noise)
    elif family == "wavegrad":
        real = synthesizer.wavegrad_inference

        def inference(model, mel, schedule, **kw):
            shape = (mel.shape[0], mel.shape[1] * model.hop, 1)
            draws = jax_wavegrad_draws(shape, len(schedule[0]), jax.random.PRNGKey(0))
            return real(model, mel, schedule, noise=torch.from_numpy(draws))
        monkeypatch.setattr(synthesizer, "wavegrad_inference", inference)
    else:
        real = wavernn.Wavernn.generate

        def generate(self, mels, generator=None, noise=None):
            T = (mels.shape[1] - 4) * self.hop
            return real(self, mels, noise=jax_wavernn_draws(self.mode, self.n_classes, T,
                                                            mels.shape[0],
                                                            jax.random.PRNGKey(0)))
        monkeypatch.setattr(wavernn.Wavernn, "generate", generate)
    yield
    monkeypatch.undo()


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs diff {err}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_synthesizer_matches_jax(family, slice_dir, monkeypatch):
    """The sentence decoded for its whole budget, through the bridge and the
    vocoder, followed by the 10000-sample gap, within 1e-5 of the JAX
    package on the same noise; the reference-layout files speak as the
    port's own do, sample for sample."""
    want = jax_wav(slice_dir, family)
    with jax_noise_in_port(family, monkeypatch):
        synth = Synthesizer(device="cpu", **_files(slice_dir, family))
        wav = np.asarray(synth.tts(TEXT), np.float32)
        reference = np.asarray(Synthesizer(device="cpu", **_files(
            slice_dir, family, "model_file.pth")).tts(TEXT), np.float32)
    assert synth.output_sample_rate == FAMILIES[family][3]
    _close(wav, want)
    np.testing.assert_array_equal(reference, wav)
    assert np.all(wav[-SENTENCE_GAP:] == 0) and np.abs(wav).max() > 0.01


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tts_api_and_cli_with_vocoder_path(family, slice_dir, tmp_path):
    """``tts --model_path --vocoder_path`` on the reference-layout files
    writes its file within one int16 step of ``TTS(model_path=...,
    vocoder_path=...).tts_to_file`` on the port's own: the port's draws
    repeat from call to call."""
    files = _files(slice_dir, family)
    api = TTS(model_path=files["tts_checkpoint"], config_path=files["tts_config_path"],
              vocoder_path=files["vocoder_checkpoint"],
              vocoder_config_path=files["vocoder_config"], device="cpu")
    want = api.tts_to_file(TEXT, file_path=str(tmp_path / "api.wav"))
    ref = _files(slice_dir, family, "model_file.pth")
    out = tmp_path / "cli.wav"
    port_cli(["--text", TEXT, "--model_path", ref["tts_checkpoint"], "--config_path",
              ref["tts_config_path"], "--vocoder_path", ref["vocoder_checkpoint"],
              "--vocoder_config_path", ref["vocoder_config"], "--out_path", str(out),
              "--device", "cpu"])
    sr, got = scipy.io.wavfile.read(out)
    _, expected = scipy.io.wavfile.read(want)
    assert sr == FAMILIES[family][3] and got.shape == expected.shape
    assert np.abs(got.astype(np.int32) - expected.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("family", ["parallel_wavegan", "univnet", "wavegrad"])
def test_server_serves_serially(family, slice_dir):
    """``--max_batch 4`` with a vocoder: the server says it serves the mel
    model serially, and ``/api/tts`` answers with the synthesizer's audio
    within one int16 step."""
    files = _files(slice_dir, family)
    args = build_parser().parse_args([
        "--model_path", files["tts_checkpoint"], "--config_path", files["tts_config_path"],
        "--vocoder_path", files["vocoder_checkpoint"], "--vocoder_config_path",
        files["vocoder_config"], "--max_batch", "4", "--port", "0", "--device", "cpu"])
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        srv = server_from_args(args)
    assert "serving serially" in said.getvalue() and srv.batcher is None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?" + urllib.parse.urlencode(
            {"text": TEXT})
        with urllib.request.urlopen(url, timeout=120) as r:
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(r.read()))
    finally:
        close_server(srv)
    wav = np.asarray(Synthesizer(device="cpu", **files).tts(TEXT), np.float32)
    want = (wav * (32767 / max(0.01, float(np.abs(wav).max())))).astype(np.int16)
    assert sr == FAMILIES[family][3] and pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# the zoo by name, offline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_home(slice_dir, tmp_path_factory):
    """A ``TTS_HOME`` holding, in the reference layout (``model_file.pth``,
    ``config.json``), the tiny Tacotron2 under each of the three entries and
    the tiny generator of its family under each of the five vocoder
    entries."""
    home = tmp_path_factory.mktemp("tts_home")
    for name in ZOO:
        shutil.copytree(slice_dir / "t2", zoo_dir(home, name))
    for name, family in VOCODER_ENTRIES.items():
        shutil.copytree(slice_dir / family, zoo_dir(home, name))
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


@pytest.mark.parametrize("name", list(ZOO) + list(VOCODER_ENTRIES))
def test_zoo_names_load_offline(name, offline, tmp_path):
    """Each Tacotron2 entry loads by name with its catalog's default vocoder
    and speaks as the same files loaded by path; each vocoder entry loads by
    ``tts --vocoder_name`` beside the Tacotron2 loaded by path, within one
    int16 step of the same files loaded by path. Nothing is fetched."""
    if name in ZOO:
        tts = TTS(model_name=name, device="cpu")
        vocoder, t2 = zoo_dir(offline, ZOO[name]), zoo_dir(offline, name)
        family = FAMILY_OF[ZOO[name].rsplit("/", 1)[1]]
        assert tts.synthesizer.tts_config.model == "tacotron2"
        assert tts.synthesizer.vocoder_config.generator_model.startswith(family)
        by_name = np.asarray(tts.tts(TEXT), np.float32)
        by_path = TTS(model_path=str(t2 / "model_file.pth"), config_path=str(t2 / "config.json"),
                      vocoder_path=str(vocoder / "model_file.pth"),
                      vocoder_config_path=str(vocoder / "config.json"), device="cpu")
        np.testing.assert_array_equal(by_name, np.asarray(by_path.tts(TEXT), np.float32))
        assert by_name.shape[0] > SENTENCE_GAP and np.abs(by_name).max() > 0.01
        return
    checkpoint, config = download_vocoder(name)
    assert checkpoint == str(zoo_dir(offline, name) / "model_file.pth")
    t2 = zoo_dir(offline, "tts_models/en/ek1/tacotron2")
    path_args = ["--text", TEXT, "--model_path", str(t2 / "model_file.pth"), "--config_path",
                 str(t2 / "config.json"), "--device", "cpu"]
    port_cli(path_args + ["--vocoder_name", name, "--out_path", str(tmp_path / "name.wav")])
    port_cli(path_args + ["--vocoder_path", checkpoint, "--vocoder_config_path", config,
                          "--out_path", str(tmp_path / "path.wav")])
    sr, got = scipy.io.wavfile.read(tmp_path / "name.wav")
    _, want = scipy.io.wavfile.read(tmp_path / "path.wav")
    assert sr == FAMILIES[VOCODER_ENTRIES[name]][3] and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.abs(got).max() > 300
