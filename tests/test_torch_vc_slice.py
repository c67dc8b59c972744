"""FreeVC through the port's surfaces, on the CPU and offline: the
``Synthesizer``'s ``vc_checkpoint`` and ``voice_conversion`` (against the
JAX ``Synthesizer``), ``TTS(model_name="voice_conversion_models/...")``,
``TTS.voice_conversion_to_file``, ``tts_with_vc_to_file`` and the ``tts``
command line's ``--source_wav``/``--target_wav``.

The fixture is a ``TTS_HOME`` holding a WavLM-Large-style WavLM (pre-LN,
gated relative position bias, 32 wide; ``tests/test_torch_wavlm.py``'s
``LARGE_STYLE``) in the reference layout at ``wavlm/WavLM-Large.pt``, and
the zoo's ``freevc24`` directory with a small FreeVC (content 32 wide) as a
reference-layout ``model.pth`` and its ``config.json``; a copy of the
catalog as ``TTS_TPU_MODELS_FILE``; any fetch fails. The port replays the
JAX package's draw (``tests/test_torch_freevc.py``'s ``jax_draw``) where it
is compared with the JAX package, whose WavLM is then built by hand (its
``load_wavlm`` fails on a WavLM with relative positions, F44); between the
port's own surfaces each call draws from a generator seeded 0, so they
agree sample for sample.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import shutil
import tempfile
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_freevc import drawn_freevc_params, jax_draw, replayed, small_config, write_wav
from test_torch_vits_model import tiny_vits_args
from test_torch_wavlm import LARGE_STYLE, drawn_wavlm_params

from tts_tpu.utils.convert import convert_wavlm as jax_convert_wavlm
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu.vc.configs import FreeVCConfig as JaxFreeVCConfig
from tts_tpu.vc.modules import wavlm as jax_wavlm
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.utils.convert import (
    freevc_from_jax_params,
    reference_freevc_state,
    reference_wavlm_state,
    wavlm_from_jax_params,
)
from tts_tpu_torch.utils.synthesizer import Synthesizer
from tts_tpu_torch.vc.modules.wavlm import WavLM, WavLMConfig, load_wavlm

FREEVC = "voice_conversion_models/multilingual/vctk/freevc24"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """``(TTS_HOME, FreeVC flax params, the zoo directory)``; the wavs
    ``src.wav`` (1.2 s at 16 kHz) and ``tgt.wav`` (2.5 s at 22.05 kHz) in
    the home's root."""
    root = tmp_path_factory.mktemp("vc_home")
    wl_params = drawn_wavlm_params(jax_wavlm.WavLMConfig(**LARGE_STYLE), seed=7)
    wl = WavLM(WavLMConfig(**LARGE_STYLE))
    wl.load_state_dict(wavlm_from_jax_params(wl_params), strict=True)
    (root / "wavlm").mkdir()
    torch.save({"cfg": wl.cfg.to_checkpoint_cfg(),
                "model": {k: torch.from_numpy(v)
                          for k, v in reference_wavlm_state(wl.state_dict()).items()}},
               root / "wavlm" / "WavLM-Large.pt")

    jax_config = small_config(JaxFreeVCConfig, ssl_dim=32)
    params = drawn_freevc_params(jax_config, seed=3)
    zoo = root / "tts_tpu" / FREEVC.replace("/", "--")
    zoo.mkdir(parents=True)
    state = freevc_from_jax_params(params)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_freevc_state(state).items()}}, zoo / "model.pth")
    with open(zoo / "config.json", "w") as f:
        json.dump(jax_config.to_dict(), f)
    shutil.copy(os.path.join(REPO, "tts_tpu_torch", "zoo", "models.json"), root / "models.json")
    write_wav(root / "src.wav", 1.2, 16000, seed=0)
    write_wav(root / "tgt.wav", 2.5, 22050, seed=1)
    return root, params, zoo


@pytest.fixture
def offline(home, monkeypatch):
    root = home[0]
    monkeypatch.setenv("TTS_HOME", str(root))
    monkeypatch.setenv("TTS_TPU_MODELS_FILE", str(root / "models.json"))

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return home


def by_path(zoo) -> Synthesizer:
    return Synthesizer(vc_checkpoint=str(zoo / "model.pth"), vc_config=str(zoo / "config.json"),
                       device="cpu")


def test_synthesizer_voice_conversion_matches_jax(offline, tmp_path):
    """The port's ``Synthesizer(vc_checkpoint=...)`` on the reference-layout
    ``model.pth`` against the JAX ``Synthesizer`` on the same weights
    (``.msgpack``), both reading WavLM from ``$TTS_HOME/wavlm/``: the same
    waveform within 1e-5 on the JAX draw, the output rate the VC config's."""
    root, params, zoo = offline
    ckpt = tmp_path / "freevc.msgpack"
    save_checkpoint(str(ckpt), params, config=small_config(JaxFreeVCConfig, ssl_dim=32))
    jax_synth = JaxSynthesizer(vc_checkpoint=str(ckpt), vc_config=str(zoo / "config.json"))
    jax_synth.vc_model.content_extractor = jax_extractor(root / "wavlm" / "WavLM-Large.pt")
    src, tgt = str(root / "src.wav"), str(root / "tgt.wav")
    want = np.asarray(jax_synth.voice_conversion(src, tgt), np.float32)

    synth = by_path(zoo)
    eps = jax_draw(jax_synth.vc_model.module, params, (1, len(want) // 16, 8))
    with replayed({eps.shape: eps}):
        got = np.asarray(synth.voice_conversion(src, tgt), np.float32)
    assert got.shape == want.shape and len(want) == len(want) // 16 * 16
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert synth.output_sample_rate == jax_synth.output_sample_rate == 24000


def jax_extractor(path):
    """The JAX package's WavLM on a reference checkpoint, its params as JAX
    arrays: ``load_wavlm`` itself fails on this one (F44)."""
    cfg, params = jax_convert_wavlm(str(path))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jax.jit(lambda w: jax_wavlm.WavLM(cfg).apply(params, w))


def test_f44_jax_load_wavlm_fails_on_relative_positions(offline, tmp_path):
    """F44 (settled in the port): the JAX ``load_wavlm`` closes its numpy
    params over ``jax.jit``, and ``WavLM``'s layer 0 indexes that numpy
    ``relative_attention_bias`` with the bucket ids, which are traced there,
    so every WavLM with relative position embedding (WavLM-Large's) raises on
    its first call. The port's ``load_wavlm`` reads the same file and
    computes the features the JAX module gives on JAX arrays."""
    root = offline[0]
    path = tmp_path / "WavLM-Large.pt"
    shutil.copy(root / "wavlm" / "WavLM-Large.pt", path)
    wav = np.random.RandomState(0).randn(1, 3200).astype(np.float32) * 0.3
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax_wavlm.load_wavlm(str(path))(wav)
    with torch.no_grad():
        got = load_wavlm(str(path), device="cpu")(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax_extractor(path)(wav))
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()


def test_tts_by_zoo_name_equals_the_path_load(offline, tmp_path):
    """``TTS(model_name=".../freevc24")`` loads the zoo directory into a
    voice converter (no TTS model), nothing fetched and nothing written
    beside WavLM; its audio equals the path load's, sample for sample, and
    ``voice_conversion_to_file`` writes it at 24 kHz."""
    root, _, zoo = offline
    src, tgt = str(root / "src.wav"), str(root / "tgt.wav")
    before = sorted(os.listdir(root / "wavlm")), sorted(os.listdir(zoo))
    tts = TTS(model_name=FREEVC, device="cpu")
    assert tts.synthesizer is None and tts.voice_converter is not None
    got = np.asarray(tts.voice_conversion(source_wav=src, target_wav=[tgt]), np.float32)
    want = np.asarray(by_path(zoo).voice_conversion(src, tgt), np.float32)
    np.testing.assert_array_equal(got, want)
    out = tmp_path / "vc.wav"
    assert tts.voice_conversion_to_file(source_wav=src, target_wav=tgt,
                                        file_path=str(out)) == str(out)
    sr, pcm = scipy.io.wavfile.read(out)
    assert sr == 24000 and pcm.shape == got.shape
    np.testing.assert_allclose(pcm / 32767, got / np.abs(got).max(), atol=1.5 / 32767)
    assert (sorted(os.listdir(root / "wavlm")), sorted(os.listdir(zoo))) == before


@pytest.fixture(scope="module")
def vits_dir(tmp_path_factory):
    """A tiny single-speaker VITS (graphemes, 22.05 kHz) as ``model_torch.pt``
    and ``config.json``."""
    d = tmp_path_factory.mktemp("vits")
    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
    for k, v in tiny_vits_args(num_chars=None).items():
        setattr(config.model_args, k, v)
    model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    torch.save(model.module.state_dict(), d / "model_torch.pt")
    with open(d / "config.json", "w") as f:
        json.dump(model.config.to_dict(), f)
    return d


def test_tts_with_vc_to_file(offline, vits_dir, tmp_path, monkeypatch):
    """A VITS loaded by path speaks, and ``freevc24``, loaded by name on
    first use, converts that into the target's voice: the file holds what
    ``voice_conversion`` of the synthesized wav gives, at 24 kHz; the
    intermediate wav is removed."""
    root, _, zoo = offline
    tgt = str(root / "tgt.wav")
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    tts = TTS(model_path=str(vits_dir), device="cpu")
    assert tts.voice_converter is None
    out = tmp_path / "with_vc.wav"
    assert tts.tts_with_vc_to_file("Be a voice, not an echo.", speaker_wav=tgt,
                                   file_path=str(out)) == str(out)
    assert tts.voice_converter is not None
    assert not [f for f in os.listdir(scratch) if f.endswith(".wav")]

    spoken = tmp_path / "spoken.wav"
    tts.tts_to_file("Be a voice, not an echo.", file_path=str(spoken))
    want = np.asarray(by_path(zoo).voice_conversion(str(spoken), tgt), np.float32)
    sr, pcm = scipy.io.wavfile.read(out)
    assert sr == 24000 and pcm.shape == want.shape
    np.testing.assert_allclose(pcm / 32767, want / np.abs(want).max(), atol=1.5 / 32767)
    assert tts.synthesizer.output_sample_rate == 22050  # the TTS model keeps its own rate


def test_cli_source_and_target_wav(offline, tmp_path, capsys):
    """``tts --model_name .../freevc24 --source_wav --target_wav`` writes
    within one int16 step of ``TTS.voice_conversion_to_file``."""
    root, _, _ = offline
    src, tgt = str(root / "src.wav"), str(root / "tgt.wav")
    api, cli = tmp_path / "api.wav", tmp_path / "cli.wav"
    TTS(model_name=FREEVC, device="cpu").voice_conversion_to_file(src, tgt, file_path=str(api))
    port_cli(["--model_name", FREEVC, "--source_wav", src, "--target_wav", tgt,
              "--out_path", str(cli), "--device", "cpu"])
    assert "Saving output to" in capsys.readouterr().out
    (sa, a), (sb, b) = (scipy.io.wavfile.read(p) for p in (api, cli))
    assert sa == sb == 24000 and a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_voice_conversion_without_a_converter_raises(vits_dir):
    """A ``TTS`` holding only a TTS model has no voice converter: the
    ``Synthesizer`` says so, as the JAX one does."""
    tts = TTS(model_path=str(vits_dir), device="cpu")
    with pytest.raises(RuntimeError, match="No voice-conversion model loaded"):
        tts.voice_conversion(source_wav="a.wav", target_wav="b.wav")
    with pytest.raises(RuntimeError, match="No model loaded"):
        TTS(device="cpu").voice_conversion(source_wav="a.wav", target_wav="b.wav")
