"""The port's VITS slice with phonemes, end to end against the JAX package,
on the CPU: the ``TTS`` API, the ``tts`` command line and the server's
routes.

One tiny model directory (``test_torch_vits_model.tiny_vits_args``: hidden
32, 2 layers) carries the LJSpeech recipe's text fields
(``english_cleaners``, ``use_phonemes=True``, ``phoneme_language="en-us"``,
blanks), so the text reaches the model as IPA from the rule G2P that both
packages pick on a machine without ``espeak``. It holds ``config.json``, the
JAX package's ``model.msgpack`` and the port's ``model_torch.pt`` with the
same weights. As in ``test_torch_vits_slice.py``, the JAX runs are made with
jit disabled and their ``jax.random.normal`` draws are replayed into the
port: lengths must be equal and samples agree within 1e-4, or within one
int16 step where they went through a peak-normalised 16-bit wav. The port
decodes a two-sentence text as one sequence-packed grid, so the JAX runs of
TEXT take the JAX ``Synthesizer``'s packed path (``use_griffin_lim=False``,
which its default gates off: ROADMAP.md F1), planned with the port's row
billing; one-sentence texts keep the serial loop in both.

Both packages' phonemizer registries hold what a fresh interpreter reads
on this machine while these tests run (``test_torch_phonemes.
machine_registries``: other test files install stub G2P modules).

One divergence is named here: with ``--pipe_out`` the JAX command line
prints its log lines into stdout, in the middle of the wav bytes; the
port's writes only the wav there and its log lines to stderr.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import json
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_packed_serving import jax_packing_as_port
from test_torch_phonemes import machine_registries
from test_torch_vits_model import record_jax_normals, replay_normals, tiny_jax_vits

from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.bin.synthesize import make_parser
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer
from tts_tpu_torch.utils.convert import vits_from_jax_params

ATOL = 1e-4
TEXT = "Be a voice, not an echo! It cost $3 at 10:30."
SHORT = "Be a voice, not an echo!"
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=True, phoneme_language="en-us",
              add_blank=True)
NUM_CHARS = 131  # the recipe's IPAPhonemes


@pytest.fixture(scope="module", autouse=True)
def registries():
    with machine_registries() as fresh:
        yield fresh


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tts_tpu.utils.io import save_checkpoint

    from tts_tpu_torch.models.vits import Vits, VitsConfig

    d = tmp_path_factory.mktemp("vits_phonemes")
    jm, params = tiny_jax_vits(seed=3, config_kw=RECIPE, num_chars=NUM_CHARS)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    port = Vits(VitsConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(vits_from_jax_params(params))
    torch.save(port.module.state_dict(), d / "model_torch.pt")
    return d


@contextlib.contextmanager
def jax_eager_draws():
    """Jit off in this thread, packed grids planned as the port plans them,
    and every ``jax.random.normal`` draw recorded."""
    with jax.disable_jit(), jax_packing_as_port(), record_jax_normals() as draws:
        yield draws


@pytest.fixture(scope="module")
def jax_reference(model_dir):
    from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer

    synth = JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                           tts_config_path=str(model_dir / "config.json"),
                           use_griffin_lim=False)  # its packed path (F1)
    assert synth.tts_model.tokenizer.phonemizer.name() == "en_g2p"
    with jax_eager_draws() as draws:
        wav = np.asarray(synth.tts(TEXT), np.float32)
    return wav, draws


def _read_wav(path_or_bytes):
    sr, pcm = scipy.io.wavfile.read(path_or_bytes)
    assert sr == 22050 and pcm.dtype == np.int16
    return pcm.astype(np.int32)


def test_tts_api_speaks_phonemes_like_jax(model_dir, jax_reference):
    want, draws = jax_reference
    tts = TTS(model_path=str(model_dir), device="cpu")
    tokenizer = tts.synthesizer.tts_model.tokenizer
    assert tokenizer.use_phonemes and tokenizer.phonemizer.name() == "en_g2p"
    assert tts.synthesizer.tts_model.config.phonemizer == "en_g2p"  # written back
    assert len(draws) == 3  # two sentences packed: durations, durations, grid noise
    with replay_normals(draws):
        wav = np.asarray(tts.tts(TEXT), np.float32)
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=0, atol=ATOL)
    assert np.abs(wav[:-SENTENCE_GAP]).max() > 0.01


def test_cli_writes_the_jax_clis_wav(model_dir, jax_reference, tmp_path, monkeypatch):
    """The JAX command line builds its ``Synthesizer`` with
    ``use_griffin_lim=False`` here, so that it packs TEXT as the port's
    does (F1)."""
    import functools

    import tts_tpu.api as jax_api
    from tts_tpu.bin.synthesize import main as jax_cli

    monkeypatch.setattr(jax_api, "Synthesizer",
                        functools.partial(jax_api.Synthesizer, use_griffin_lim=False))
    jax_out, port_out = tmp_path / "jax.wav", tmp_path / "port.wav"
    monkeypatch.setattr(sys, "argv", [
        "tts", "--text", TEXT, "--model_path", str(model_dir / "model.msgpack"),
        "--config_path", str(model_dir / "config.json"), "--out_path", str(jax_out)])
    with jax_eager_draws() as draws:
        jax_cli()
    assert [d.shape for d in draws] == [d.shape for d in jax_reference[1]]
    with replay_normals(draws):
        port_cli(["--text", TEXT, "--model_path", str(model_dir / "model_torch.pt"),
                  "--config_path", str(model_dir / "config.json"), "--out_path", str(port_out),
                  "--device", "cpu", "--use_cuda", "--save_spectogram", "--progress_bar", "false"])
    got, want = _read_wav(port_out), _read_wav(jax_out)
    assert got.shape == want.shape == jax_reference[0].shape
    assert np.abs(got - want).max() <= 1


def test_cli_pipes_only_the_wav_to_stdout(model_dir, tmp_path, monkeypatch, capsys):
    out = tmp_path / "piped.wav"
    stdout = io.TextIOWrapper(io.BytesIO())
    monkeypatch.setattr(sys, "stdout", stdout)
    port_cli(["--text", SHORT, "--model_path", str(model_dir), "--out_path", str(out),
              "--device", "cpu", "--pipe_out"])
    stdout.flush()
    assert stdout.buffer.getvalue() == out.read_bytes()
    assert "Saving output to" in capsys.readouterr().err


def test_cli_needs_text_and_rejects_unported_flags(model_dir, capsys):
    """The command line needs ``--text``; every flag of the JAX command
    line parses: the style flags (GST and Capacitron), the voice
    conversion flags (FreeVC) and, with Tortoise, ``--voice_dir``."""
    with pytest.raises(SystemExit) as exit_info:
        port_cli(["--model_path", str(model_dir), "--device", "cpu"])
    assert exit_info.value.code == 1 and "Provide --text" in capsys.readouterr().err
    args = make_parser().parse_args(["--text", "hi", "--voice_dir", "voices"])
    assert args.voice_dir == "voices"
    args = make_parser().parse_args(["--source_wav", "a.wav", "--target_wav", "t.wav"])
    assert (args.source_wav, args.target_wav) == ("a.wav", "t.wav")
    for flag in ("--style_wav", "--gst_style", "--capacitron_style_wav"):
        args = make_parser().parse_args(["--text", "hi", flag, "s.wav",
                                         "--capacitron_style_text", "Words."])
        assert (args.style_wav, args.style_text) == ("s.wav", "Words.")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_cli(["--text", "hi", "--model_path", str(model_dir)])


class _EagerJaxSynthesizer:
    """The JAX ``Synthesizer`` with jit off in whichever thread calls
    ``tts``, so that the server's draws are recorded."""

    def __init__(self, synth):
        self._synth = synth

    def __getattr__(self, name):
        return getattr(self._synth, name)

    def tts(self, *args, **kwargs):
        with jax.disable_jit():
            return self._synth.tts(*args, **kwargs)


def _request(base, path, data=None):
    req = urllib.request.Request(base + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _serve(synth, server_module, replay=None):
    """Every route but the streaming one, in order, through ``synth``'s server."""
    srv = server_module.create_server(synth, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    form = urllib.parse.urlencode({"INPUT_TEXT": SHORT}).encode()
    try:
        with replay or contextlib.nullcontext():
            return {
                "details": _request(base, "/details"),
                "locales": _request(base, "/locales"),
                "voices": _request(base, "/voices"),
                "process GET": _request(base, "/process?" + form.decode()),
                "process POST": _request(base, "/process", data=form),
                "POST elsewhere": _request(base, "/api/tts", data=form),
                "GET elsewhere": _request(base, "/nowhere"),
            }
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_routes_answer_as_jax(model_dir):
    from tts_tpu.server import server as jax_server
    from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer

    from tts_tpu_torch.server import server as port_server

    jax_synth = JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                               tts_config_path=str(model_dir / "config.json"))
    with record_jax_normals() as draws:
        want = _serve(_EagerJaxSynthesizer(jax_synth), jax_server)
    assert len(draws) == 6  # /process twice: durations, durations, prior noise
    port_synth = Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                             tts_config_path=str(model_dir / "config.json"), device="cpu")
    got = _serve(port_synth, port_server, replay_normals(draws))

    assert sorted(got) == sorted(want)
    for route in want:
        assert got[route][:2] == want[route][:2], route  # status, content type
    assert [got[r][0] for r in ("details", "locales", "voices", "process GET", "process POST",
                                "POST elsewhere", "GET elsewhere")] == [200] * 5 + [404] * 2
    for route in ("locales", "voices", "POST elsewhere", "GET elsewhere"):
        assert got[route][2] == want[route][2], route
    got_details, want_details = json.loads(got["details"][2]), json.loads(want["details"][2])
    assert got_details == want_details
    assert got_details["speakers"] == got_details["languages"] == []
    assert got_details["tts_config"]["model"] == "vits"
    assert got_details["tts_config"]["phoneme_language"] == "en-us"
    for route in ("process GET", "process POST"):
        pcm, want_pcm = _read_wav(io.BytesIO(got[route][2])), _read_wav(io.BytesIO(want[route][2]))
        assert pcm.shape == want_pcm.shape and len(pcm) > SENTENCE_GAP
        assert np.abs(pcm - want_pcm).max() <= 1, route
