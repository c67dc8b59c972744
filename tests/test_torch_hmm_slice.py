"""Overflow with HiFiGAN through the port's user surfaces, against the JAX
package, on the CPU: the ``Synthesizer``'s mel → vocoder bridge,
``TTS(model_path=..., vocoder_path=...)``, the ``tts`` command line's
``--vocoder_path``, the server (which serves a mel model serially), and the
zoo by name: ``tts_models/en/ljspeech/overflow`` and ``.../neural_hmm``
with their ``hifigan_v2``, from offline reference-layout directories.

One tiny Overflow (``test_torch_overflow``'s widths with 16 mels, graphemes
with ``english_cleaners``, folded norms as a converted checkpoint has them,
mel statistics -4 and 2) and the tiny HiFiGAN of
``test_torch_tacotron2_slice`` (16 kHz, hop 64) are written as the JAX
package's ``.msgpack`` checkpoints, the port's ``model_torch.pt`` and the
reference layout's ``model_file.pth`` (with ``mean``/``std``), each beside
its ``config.json``. The weights are drawn at 0.1 (the autoregressive
memory then carries fp32 rounding through a whole sentence unamplified),
the transition column at 40 times that with bias 0 (``TRANSITION``), so
that each sentence of ``TEXT`` leaves its last state well inside its
budget: one frame a state, since random weights make the stay/move rule
bistable (a state's move probability settles, so a state lasts one frame
or never ends). The same text goes through the JAX ``Synthesizer`` and the
port's; the waveforms, each sentence trimmed at its endpoint as both
packages trim a model loaded from a file, agree within 1e-5.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import shutil
import threading
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_glow_tts import drawn_params
from test_torch_tacotron2_slice import AUDIO, HIFIGAN_V2, write_hifigan, write_json

from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
from tts_tpu.models.overflow import NeuralhmmTTS as JaxNeuralhmmTTS
from tts_tpu.models.overflow import NeuralhmmTTSConfig as JaxNeuralhmmTTSConfig
from tts_tpu.models.overflow import Overflow as JaxOverflow
from tts_tpu.models.overflow import OverflowConfig as JaxOverflowConfig
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models import config_from_dict
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
from tts_tpu_torch.utils.convert import overflow_from_jax_params, reference_overflow_state
from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

ATOL = 1e-5
DRAW_SCALE = 0.1
TRANSITION = (40.0, 0.0)  # the transition column's scale and its bias
TEXT = "Be a voice, not an echo. Prior to November 22, 1963."
OVERFLOW = "tts_models/en/ljspeech/overflow"
NEURAL_HMM = "tts_models/en/ljspeech/neural_hmm"
MODEL_KW = dict(out_channels=16, num_chars=None, state_per_phone=2, encoder_in_out_features=32,
                memory_rnn_dim=32, prenet_dim=16, outputnet_size=[32],
                text_cleaner="english_cleaners", use_phonemes=False, norm_type="folded",
                mel_statistics_mean=-4.0, mel_statistics_std=2.0)
FLOW_KW = dict(hidden_channels_dec=16, num_flow_blocks_dec=2, num_block_layers=2)
KINDS = {"overflow": (JaxOverflow, JaxOverflowConfig, FLOW_KW),
         "neuralhmm": (JaxNeuralhmmTTS, JaxNeuralhmmTTSConfig, {})}


def write_hmm(d, kind="overflow", seed=0):
    """The tiny Overflow (or NeuralHMM) in the JAX, port and reference
    layouts with its ``config.json`` under ``d``."""
    d.mkdir()
    jax_cls, jax_config, extra = KINDS[kind]
    config = jax_config(**MODEL_KW, **extra, audio=JaxAudioConfig(**AUDIO))
    jm = jax_cls.init_from_config(config)
    params = jax.tree_util.tree_map(np.array, drawn_params(jm.init_params, jax.random.PRNGKey(0),
                                                           seed=seed, scale=DRAW_SCALE))
    rs = np.random.RandomState(seed + 1)
    for name, leaf in params["params"].get("decoder", {}).items():
        if name.startswith("invconv"):
            s = leaf["weight"].shape[0]
            leaf["weight"] = np.linalg.qr(rs.randn(s, s))[0].astype(np.float32)
    for i in range(2):  # the reference's prenet has no bias
        params["params"]["neural_hmm"]["prenet"][f"linear_{i}"]["bias"][:] = 0
    proj = params["params"]["neural_hmm"]["output_net"]["proj"]
    proj["kernel"][:, -1] *= TRANSITION[0]
    proj["bias"][-1] = TRANSITION[1]
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    port_config = config_from_dict(jm.config.to_dict())
    state = overflow_from_jax_params(params)
    torch.save(state, d / "model_torch.pt")
    reference = reference_overflow_state(state, mean=port_config.mel_statistics_mean,
                                         std=port_config.mel_statistics_std)
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in reference.items()}},
               d / "model_file.pth")
    write_json(d / "config.json", jm.config.to_dict())


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("overflow_hifigan")
    write_hmm(d / "hmm")
    write_hifigan(d / "voc")
    return d


def port_synth(d, weights="model_torch.pt"):
    return Synthesizer(tts_checkpoint=str(d / "hmm" / weights),
                       tts_config_path=str(d / "hmm" / "config.json"), device="cpu",
                       vocoder_checkpoint=str(d / "voc" / weights),
                       vocoder_config=str(d / "voc" / "config.json"))


@pytest.fixture(scope="module")
def jax_wav(pair_dir):
    synth = JaxSynthesizer(tts_checkpoint=str(pair_dir / "hmm" / "model.msgpack"),
                           tts_config_path=str(pair_dir / "hmm" / "config.json"),
                           vocoder_checkpoint=str(pair_dir / "voc" / "model.msgpack"),
                           vocoder_config=str(pair_dir / "voc" / "config.json"))
    return np.asarray(synth.tts(TEXT), np.float32)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs diff {err}"
    return err


def _pcm_close(a_path, b_path):
    """Two wav files of one rate and length within one int16 step."""
    (sr_a, a), (sr_b, b) = (scipy.io.wavfile.read(p) for p in (a_path, b_path))
    assert sr_a == sr_b and a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_synthesizer_with_hifigan_matches_jax(pair_dir, jax_wav):
    """Two sentences, each decoded to its last state inside its budget,
    denormalised by the mel statistics, vocoded by HiFiGAN (the bridge is
    the identity: one audio config), trimmed and followed by the
    10000-sample gap; the reference-layout pair speaks as the port's own
    files do. Each sentence's decode ends before its budget, so the early
    exit ran."""
    synth = port_synth(pair_dir)
    model = synth.tts_model
    assert synth.output_sample_rate == 16000 and synth.from_file
    wav = np.asarray(synth.tts(TEXT), np.float32)
    err = _close(wav, jax_wav)
    assert np.all(wav[-SENTENCE_GAP:] == 0) and np.abs(wav).max() > 0.01
    reference = port_synth(pair_dir, "model_file.pth")
    assert (reference.tts_config.mel_statistics_mean, reference.tts_config.norm_type) == \
        (-4.0, "folded")
    np.testing.assert_array_equal(np.asarray(reference.tts(TEXT), np.float32), wav)
    for sentence in ("Be a voice, not an echo.", "Prior to November 22, 1963."):
        with torch.no_grad():
            out = synthesis(model, sentence)["outputs"]
        budget = _frame_budget(len(model.tokenizer.text_to_ids(sentence)))
        assert 0 < int(out["y_lengths"][0]) < out["transitions"].shape[1] < budget
    print(f"Overflow + HiFiGAN through the Synthesizer: {len(wav)} samples, max abs diff "
          f"{err:.3g} to the JAX Synthesizer")


def test_tts_api_and_cli_with_vocoder_path(pair_dir, jax_wav, tmp_path):
    """``TTS(model_path=..., vocoder_path=...)`` speaks as the JAX
    ``Synthesizer`` does, and ``tts --model_path --vocoder_path`` on the
    reference-layout files writes its file within one int16 step."""
    api = TTS(model_path=str(pair_dir / "hmm" / "model_torch.pt"),
              config_path=str(pair_dir / "hmm" / "config.json"),
              vocoder_path=str(pair_dir / "voc" / "model_torch.pt"),
              vocoder_config_path=str(pair_dir / "voc" / "config.json"), device="cpu")
    _close(api.tts(TEXT), jax_wav)
    want = api.tts_to_file(TEXT, file_path=str(tmp_path / "api.wav"))
    out = tmp_path / "cli.wav"
    port_cli(["--text", TEXT, "--model_path", str(pair_dir / "hmm" / "model_file.pth"),
              "--config_path", str(pair_dir / "hmm" / "config.json"), "--vocoder_path",
              str(pair_dir / "voc" / "model_file.pth"), "--vocoder_config_path",
              str(pair_dir / "voc" / "config.json"), "--out_path", str(out), "--device", "cpu"])
    _pcm_close(out, want)


def test_server_serves_overflow_serially(pair_dir, jax_wav):
    """``--max_batch 4`` with a vocoder: the server says it serves serially
    and ``/api/tts`` answers with the synthesizer's audio."""
    args = build_parser().parse_args([
        "--model_path", str(pair_dir / "hmm" / "model_torch.pt"), "--config_path",
        str(pair_dir / "hmm" / "config.json"), "--vocoder_path",
        str(pair_dir / "voc" / "model_torch.pt"), "--vocoder_config_path",
        str(pair_dir / "voc" / "config.json"), "--max_batch", "4", "--port", "0",
        "--device", "cpu"])
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
    want = (jax_wav * (32767 / max(0.01, float(np.abs(jax_wav).max())))).astype(np.int16)
    assert sr == 16000 and pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# the zoo by name, offline
# ---------------------------------------------------------------------------


def zoo_dir(home, name):
    return home / "tts_tpu" / name.replace("/", "--")


@pytest.fixture(scope="module")
def zoo_home(pair_dir, tmp_path_factory):
    """A ``TTS_HOME`` holding, in the reference layout (``model_file.pth``
    with ``mean``/``std``, ``config.json``), the tiny Overflow under
    ``overflow``, a tiny NeuralHMM under ``neural_hmm`` and the tiny HiFiGAN
    under ``hifigan_v2``."""
    home = tmp_path_factory.mktemp("tts_home")
    write_hmm(home / "nhmm", kind="neuralhmm", seed=2)
    shutil.copytree(pair_dir / "hmm", zoo_dir(home, OVERFLOW))
    shutil.copytree(home / "nhmm", zoo_dir(home, NEURAL_HMM))
    shutil.copytree(pair_dir / "voc", zoo_dir(home, HIFIGAN_V2))
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


@pytest.mark.parametrize("name", [OVERFLOW, NEURAL_HMM])
def test_zoo_name_speaks_like_the_same_files_by_path(name, offline, tmp_path):
    """``TTS(model_name=...)`` loads the model and ``hifigan_v2`` from their
    reference-layout directories, fetching nothing, with the mel statistics
    of the checkpoint; the audio equals the same files loaded by path, and
    ``tts --model_name`` writes it within one int16 step."""
    tts = TTS(model_name=name, device="cpu")
    synth = tts.synthesizer
    assert synth.vocoder_model is not None and synth.from_file
    assert synth.tts_config.model == ("overflow" if name == OVERFLOW else "neuralhmm_tts")
    assert synth.tts_config.mel_statistics_mean == -4.0
    by_name = np.asarray(tts.tts(TEXT), np.float32)
    assert by_name.shape[0] > 2 * SENTENCE_GAP and np.abs(by_name).max() > 0.01
    model, voc = zoo_dir(offline, name), zoo_dir(offline, HIFIGAN_V2)
    by_path = TTS(model_path=str(model / "model_file.pth"), config_path=str(model / "config.json"),
                  vocoder_path=str(voc / "model_file.pth"),
                  vocoder_config_path=str(voc / "config.json"), device="cpu")
    np.testing.assert_array_equal(by_name, np.asarray(by_path.tts(TEXT), np.float32))
    port_cli(["--text", TEXT, "--model_name", name, "--out_path", str(tmp_path / "cli.wav"),
              "--device", "cpu"])
    by_path.tts_to_file(TEXT, file_path=str(tmp_path / "path.wav"))
    _pcm_close(tmp_path / "cli.wav", tmp_path / "path.wav")
