"""Tortoise through the port's surfaces, against the JAX package on the CPU:
``Tortoise.synthesize`` from a voice folder and from the random voice, the
``Synthesizer`` on a tortoise-v2 directory in the reference layout,
``TTS(voice_dir=...)``, ``tts --voice_dir``, the zoo's ``tortoise-v2`` and
the presets and errors of ``tests/test_tortoise.py``.

The small model of ``test_torch_tortoise`` (greedy AR: ``top_p`` 1e-6). The
JAX side's normal draws (the random voice's, the diffusion's initial noise,
the vocoder's) are made again from its keys (:func:`jax_draws`) and
replayed into the port (``test_torch_tortoise.replayed``); its latents are
cut without the 32-code bucket (``diffusion_length_bucket = 1``, F45). Each
vocoded sentence is held in two parts: the mel the diffusion decoder made
within 1e-4 of its peak, and the port's vocoding of the JAX mel within 1e-4
of the JAX waveform's peak (the first DDIM step multiplies fp32 rounding by
~150: ``test_torch_tortoise.test_samplers_match_jax_on_its_noise``). The
sentences' lengths and the 10000-sample gaps between them are exact.

The zoo directory holds ``autoregressive.pth``, ``diffusion_decoder.pth``,
``vocoder.pth``, ``mel_norms.pth``, ``rlg_auto.pth``, ``rlg_diffuser.pth``
and ``config.json`` written by the port's reference-layout writers; no
``clvp2.pth`` (the small CLVP is not the 768-wide one the loaders build),
so both packages keep the longest candidate.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import json
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_tortoise import jax_tiny, peak_close, port_of, replayed, rlg_state

from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.tortoise import model as tortoise
from tts_tpu_torch.utils import convert, manage

TORTOISE = "tts_models/en/multi-dataset/tortoise-v2"
TEXT = "Be a voice! Be a voice!"  # two sentences of one shape: one JAX compile
FAST = dict(max_mel_tokens=24)  # kwargs a call passes on to synthesize


def clip(seconds, f0, seed):
    t = np.arange(int(seconds * 22050)) / 22050
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * np.random.RandomState(seed).randn(len(t))
    return (wav * 32767 / 2).astype(np.int16)


def write_tortoise_dir(d, pm, jm, norms):
    """``pm``'s weights as the reference's tortoise-v2 directory."""
    d.mkdir(parents=True, exist_ok=True)
    tensors = lambda state: {k: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
                             for k, v in state.items()}
    torch.save(tensors(convert.reference_unified_voice_state(pm.autoregressive.state_dict())),
               d / "autoregressive.pth")
    torch.save(tensors(convert.reference_diffusion_state(pm.diffusion.state_dict())),
               d / "diffusion_decoder.pth")
    voc = convert.reference_tortoise_univnet_state(pm.vocoder.state_dict())
    torch.save({"model_g": tensors(voc["model_g"])}, d / "vocoder.pth")
    torch.save(torch.from_numpy(norms), d / "mel_norms.pth")
    torch.save(tensors(rlg_state(32, 0)), d / "rlg_auto.pth")
    torch.save(tensors(rlg_state(128, 1)), d / "rlg_diffuser.pth")
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f, default=list)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and the port's on the same weights (the port's loaded
    from the reference-layout directory), the directory, and a voice folder
    with two clips of ``emma``."""
    root = tmp_path_factory.mktemp("tortoise")
    jm = jax_tiny()
    jm.clvp = jm.clvp_params = None
    norms = np.linspace(0.5, 2.0, 80).astype(np.float32)
    jm.mel_norms = norms
    jm.rlg_auto_state, jm.rlg_diff_state = rlg_state(32, 0), rlg_state(128, 1)
    jm.config.model_args.diffusion_length_bucket = 1  # F45
    d = root / "tortoise-v2"
    write_tortoise_dir(d, port_of(jm, clvp=False), jm, norms)
    pm = tortoise.Tortoise(port_of(jm, clvp=False).config)
    pm.load_checkpoint(checkpoint_dir=str(d), device="cpu")
    voices = root / "voices"
    (voices / "emma").mkdir(parents=True)
    scipy.io.wavfile.write(voices / "emma" / "a.wav", 22050, clip(1.5, 180, 0))
    scipy.io.wavfile.write(voices / "emma" / "b.wav", 22050, clip(1.0, 220, 1))
    return jm, pm, d, voices


@contextlib.contextmanager
def vocoded(model, record):
    """``model.vocode`` wrapped: each call's (mel, wav) appended to
    ``record`` as numpy."""
    real = model.vocode

    def wrapper(mel, *args, **kwargs):
        wav = real(mel, *args, **kwargs)
        record.append((np.array(mel.detach().cpu() if hasattr(mel, "detach") else mel),
                       np.array(wav.detach().cpu() if hasattr(wav, "detach") else wav)))
        return wav

    model.vocode = wrapper
    try:
        yield
    finally:
        del model.vocode


def jax_draws(voice: str, T_mel: int, seed: int = 0) -> list:
    """The normal draws of the JAX ``synthesize`` under ``PRNGKey(seed)``,
    in order: the random voice's two (``voice == "random"``), the
    diffusion's initial noise, the vocoder's noise."""
    rng, draws = jax.random.PRNGKey(seed), []
    if voice == "random":
        r_v, rng = jax.random.split(rng)
        r1, r2 = jax.random.split(r_v)
        draws += [jax.random.normal(r1, (1, 32)), jax.random.normal(r2, (1, 128))]
    _, r2 = jax.random.split(rng)
    r0, _ = jax.random.split(r2)
    draws += [jax.random.normal(r0, (1, T_mel, 100)),
              jax.random.normal(jax.random.fold_in(r2, 1), (1, T_mel + 10, 8))]
    return [np.asarray(d) for d in draws]


def hold(pm, ours, theirs, draws):
    """Each vocoded sentence: the mels within 1e-4 of the JAX mel's peak,
    the port's vocoding of the JAX mel within 1e-4 of the JAX waveform's
    peak (on the JAX vocoder draw, the last of each sentence's draws)."""
    assert len(ours) == len(theirs) > 0
    vocoder_draws = [d for d in draws if d.ndim == 3 and d.shape[-1] == 8]
    for (mel, wav), (jmel, jwav), noise in zip(ours, theirs, vocoder_draws, strict=True):
        peak_close(mel, jmel, 1e-4, "mel")
        assert wav.shape == jwav.shape
        with replayed([noise]):
            again = pm.vocode(torch.from_numpy(jmel), torch.Generator())
        peak_close(again, jwav, 1e-4, "waveform of the JAX mel")


def test_loader_reads_the_reference_layout(setup):
    """``load_tortoise_checkpoint`` gives the weights the directory was
    written from, the mel norms and both random latent generators."""
    jm, pm, _, _ = setup
    twin = port_of(jm, clvp=False)
    for name in ("autoregressive", "diffusion", "vocoder"):
        for key, value in getattr(twin, name).state_dict().items():
            assert torch.equal(getattr(pm, name).state_dict()[key], value), (name, key)
    assert pm.clvp is None and torch.equal(pm.mel_norms, torch.from_numpy(jm.mel_norms))
    assert set(pm.rlg_auto) == set(jm.rlg_auto_state) and pm.rlg_diffuser is not None


@pytest.mark.parametrize("voice", ["emma", "random"])
def test_synthesize_matches_jax(setup, voice):
    """``synthesize`` with two candidates: the voice from
    ``voice_dirs/emma/*.wav`` (both clips, each loaded at 22.05 and 24 kHz)
    or from the random latent generators, the same greedy codes, the mel and
    the waveform as held in :func:`hold`."""
    jm, pm, _, voices = setup
    kw = dict(speaker_id=voice, voice_dirs=[str(voices)], **FAST)
    theirs, ours = [], []
    with vocoded(jm, theirs):
        want = jm.synthesize(TEXT, jm.config, **kw)
    draws = jax_draws(voice, theirs[0][0].shape[1])
    with replayed(draws), vocoded(pm, ours):
        got = pm.synthesize(TEXT, pm.config, **kw)
    assert got["text_inputs"] == want["text_inputs"]
    for g, w in zip(got["conditioning_latents"], want["conditioning_latents"]):
        peak_close(g, w, 1e-5, "conditioning latents")
    assert got["wav"].shape == np.asarray(want["wav"]).shape
    hold(pm, ours, theirs, draws)


def test_synthesizer_and_tts_match_the_jax_synthesizer(setup, tmp_path):
    """The port's ``TTS(model_path=dir, voice_dir=...)`` against the JAX
    ``Synthesizer(model_dir=dir, voice_dir=...)``, both loading the
    reference layout: two sentences, each vocoded sentence held as in
    :func:`hold`, each followed by 10000 zeros; 24 kHz out. A copy of the
    directory is given to the JAX package, which writes its converted
    ``.msgpack`` files beside the checkpoints."""
    import shutil

    jm, pm, d, voices = setup
    jdir = tmp_path / "jax"
    shutil.copytree(d, jdir)
    jsynth = JaxSynthesizer(model_dir=str(jdir), voice_dir=str(voices))
    jsynth.tts_model.config.model_args.diffusion_length_bucket = 1  # F45
    tts = TTS(model_path=str(d), voice_dir=str(voices), device="cpu")
    synth = tts.synthesizer
    assert synth.output_sample_rate == jsynth.output_sample_rate == 24000
    theirs, ours = [], []
    with vocoded(jsynth.tts_model, theirs):
        want = np.asarray(jsynth.tts(TEXT, speaker_name="emma", **FAST), np.float32)
    draws = [d for mel, _ in theirs for d in jax_draws("emma", mel.shape[1])]
    with replayed(draws), vocoded(synth.tts_model, ours):
        got = np.asarray(tts.tts(TEXT, speaker="emma", **FAST), np.float32)
    assert got.shape == want.shape and len(ours) == 2
    hold(synth.tts_model, ours, theirs, draws)
    start = 0
    for _, wav in ours:
        n = wav.shape[1]
        np.testing.assert_array_equal(got[start : start + n], wav[0])
        assert not got[start + n : start + n + 10000].any()
        start += n + 10000
    assert start == len(got)


@pytest.fixture(scope="module")
def stopping_dir(setup, tmp_path_factory):
    """The directory with the stop token's bias raised, so that every
    candidate stops at its first code and a whole ``synthesize`` at the
    default 500-code budget decodes 8 steps (one read of the done flags)."""
    jm, pm, _, _ = setup
    d = tmp_path_factory.mktemp("stopping") / "tortoise-v2"
    twin = port_of(jm, clvp=False)
    twin.autoregressive.mel_head.bias[99] = 100.0
    write_tortoise_dir(d, twin, jm, jm.mel_norms)
    return d


def test_tts_voice_dir_on_the_command_line(stopping_dir, setup, tmp_path):
    """``tts --model_path dir --voice_dir voices --speaker_idx emma`` writes
    the file ``TTS(voice_dir=...).tts_to_file`` writes, within one int16
    step, at 24 kHz; the codes stop at once (8 decode steps)."""
    _, _, _, voices = setup
    out_cli, out_api = tmp_path / "cli.wav", tmp_path / "api.wav"
    port_cli(["--text", TEXT, "--model_path", str(stopping_dir), "--voice_dir", str(voices),
              "--speaker_idx", "emma", "--out_path", str(out_cli), "--device", "cpu"])
    tts = TTS(model_path=str(stopping_dir), voice_dir=str(voices), device="cpu")
    steps = tts.synthesizer.tts_model.autoregressive.decode_steps
    tts.tts_to_file(TEXT, speaker="emma", file_path=str(out_api))
    assert tts.synthesizer.tts_model.autoregressive.decode_steps == steps + 2 * 8
    (sr_a, a), (sr_b, b) = (scipy.io.wavfile.read(p) for p in (out_cli, out_api))
    assert sr_a == sr_b == 24000 and a.shape == b.shape and len(a) > 20000
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.fixture
def offline_zoo(stopping_dir, tmp_path, monkeypatch):
    """``TTS_HOME`` holding the zoo's ``tortoise-v2`` directory (a copy of
    ``stopping_dir``); any fetch fails."""
    import shutil

    home = tmp_path / "home"
    shutil.copytree(stopping_dir, home / "tts_tpu" / TORTOISE.replace("/", "--"))
    monkeypatch.setenv("TTS_HOME", str(home))
    monkeypatch.delenv("TTS_TPU_MODELS_FILE", raising=False)

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return home


def test_zoo_tortoise_v2_equals_the_path_load(offline_zoo, stopping_dir, setup):
    """``TTS(model_name=".../tortoise-v2", voice_dir=...)`` loads the
    multi-file directory (``autoregressive.pth`` marks it) with nothing
    fetched, and speaks as the same files loaded by path, sample for
    sample."""
    _, _, _, voices = setup
    manager = manage.ModelManager()
    assert manage.unported_reason(TORTOISE, manager.models_dict) is None
    model_path, config_path, _ = manager.download_model(TORTOISE)
    assert model_path.endswith("tortoise-v2") and config_path.endswith("config.json")
    by_name = TTS(model_name=TORTOISE, voice_dir=str(voices), device="cpu")
    by_path = TTS(model_path=str(stopping_dir), voice_dir=str(voices), device="cpu")
    for speaker in ("emma", "random"):
        np.testing.assert_array_equal(np.asarray(by_name.tts(TEXT, speaker=speaker)),
                                      np.asarray(by_path.tts(TEXT, speaker=speaker)))


def test_presets_and_errors(setup):
    """As ``tests/test_tortoise.py`` holds the JAX package: a named speaker
    without voice material raises naming ``voice_dirs``; best-of-k with
    batch > 1 raises; an unknown preset raises; a preset fills what the
    call leaves unset and an explicit value wins. And a directory without
    ``autoregressive.pth`` raises at load."""
    jm, pm, _, voices = setup
    with pytest.raises(ValueError, match="voice_dirs"):
        pm.synthesize("Hi.", pm.config, speaker_id="emma")
    text = torch.from_numpy(np.random.RandomState(0).randint(1, 250, (2, 5)))
    cond = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 80).astype(np.float32))
    dcond = torch.from_numpy(np.random.RandomState(2).randn(2, 12, 100).astype(np.float32))
    with pytest.raises(ValueError, match="batch size 1"):
        pm.inference(text, cond, diffusion_cond_mels=dcond, num_samples=2, max_mel_tokens=4)
    with pytest.raises(ValueError, match="pass diffusion_latent or diffusion_cond_mels"):
        pm.inference(text, cond, max_mel_tokens=4)
    with pytest.raises(ValueError, match="unknown tortoise preset"):
        pm.synthesize("Hi.", pm.config, speaker_id="random", preset="warp9")
    # a directory without the AR model raises at load (the JAX loader skips
    # the missing file and fails at the first call instead)
    with pytest.raises(FileNotFoundError, match="autoregressive.pth"):
        tortoise.Tortoise(pm.config).load_checkpoint(checkpoint_dir=str(voices), device="cpu")
    seen = {}
    real = pm.inference

    def spy(text_tokens, **kw):
        seen.update(kw)
        kw["diffusion_iterations"] = 1  # keep the call short; the values are what is checked
        return real(text_tokens, **kw)

    pm.inference = spy
    try:
        pm.synthesize("Hi.", pm.config, speaker_id="random", preset="ultra_fast",
                      max_mel_tokens=4)
        assert (seen["num_samples"], seen["diffusion_iterations"], seen["sampler"]) == \
            (16, 10, "ddim")
        seen.clear()
        pm.synthesize("Hi.", pm.config, speaker_id="random", preset="ultra_fast",
                      diffusion_iterations=3, max_mel_tokens=4)
        assert seen["diffusion_iterations"] == 3 and seen["num_samples"] == 16
        seen.clear()
        pm.synthesize("Hi.", pm.config, speaker_id="random", preset="very_fast",
                      max_mel_tokens=4)
        assert (seen["num_samples"], seen["sampler"]) == (32, "dpm++2m")
    finally:
        del pm.inference
    assert set(tortoise.Tortoise.PRESETS) == set(jm.PRESETS)
    assert tortoise.Tortoise.PRESETS == jm.PRESETS
