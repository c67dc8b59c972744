"""The port's VITS slice end to end against the JAX package, on the CPU.

One tiny model directory (``test_torch_vits_model.tiny_vits_args``: hidden
32, 2 layers; graphemes with ``english_cleaners`` and blanks, as the
LJSpeech recipe minus phonemes) holds ``config.json``, the JAX package's
``model.msgpack`` and the port's ``model_torch.pt`` with the same weights.

A three-sentence text goes through the JAX ``Synthesizer.tts`` (checkpoint
file + config) and through the port's ``TTS.tts`` (model directory) and
``Synthesizer.tts`` (checkpoint file + config). The port decodes the three
sentences as one sequence-packed grid. The JAX ``Synthesizer`` does so only
with ``use_griffin_lim=False``: its default ``use_griffin_lim=True`` gates
the packed path off for a vocoder-less VITS and decodes sentence by
sentence (ROADMAP.md fault F1). So the reference is the JAX packed path,
planned with the port's row billing
(``test_torch_packed_serving.jax_packing_as_port``), and the audio is held
sample for sample, within 1e-4, with 10000 zero samples after each
sentence. The JAX run is made with jit disabled so that its
``jax.random.normal`` draws (the durations pass, then the packed decode's
duration and prior noise) can be recorded and replayed into the port.

The port's HTTP server answers ``/api/tts`` for VITS with the synthesizer's
own audio; its streaming route answers 501.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import io
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_packed_serving import jax_eager_draws
from test_torch_vits_model import record_jax_normals, replay_normals, tiny_jax_vits

from tts_tpu_torch.api import TTS
from tts_tpu_torch.server.server import close_server, create_server
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences
from tts_tpu_torch.utils.convert import vits_from_jax_params

ATOL = 1e-4
TEXT = "The 3 cats ate at 10:30. Be a voice, not an echo! Prior to November 22, 1963."
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tts_tpu.utils.io import save_checkpoint

    from tts_tpu_torch.models.vits import Vits, VitsConfig

    d = tmp_path_factory.mktemp("vits_slice")
    jm, params = tiny_jax_vits(seed=2, config_kw=RECIPE, num_chars=100)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    port = Vits(VitsConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(vits_from_jax_params(params))
    torch.save(port.module.state_dict(), d / "model_torch.pt")
    return d


@pytest.fixture(scope="module")
def jax_reference(model_dir):
    """The JAX ``Synthesizer.tts`` of TEXT on its packed path (F1) and its
    noise draws, in order."""
    from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer

    synth = JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                           tts_config_path=str(model_dir / "config.json"),
                           use_griffin_lim=False)
    with jax_eager_draws() as draws:
        wav = np.asarray(synth.tts(TEXT), np.float32)
    assert synth.output_sample_rate == 22050
    return wav, draws


def _check_against_jax(wav, jax_reference):
    want, draws = jax_reference
    wav = np.asarray(wav, np.float32)
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=0, atol=ATOL)


def test_three_sentences_decode_serially_in_both(model_dir, jax_reference):
    """F1: the JAX ``Synthesizer`` with its default ``use_griffin_lim=True``
    decodes the three sentences one by one, drawing (durations, durations,
    prior) noise for each. The packed path that gate was meant to allow,
    which the port runs, draws once for all three: the durations pass and
    the decode's duration noise over three rows, then the grid's prior
    noise."""
    from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer

    want, draws = jax_reference
    assert len(split_into_sentences(TEXT)) == 3
    default = JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                             tts_config_path=str(model_dir / "config.json"))
    with jax.disable_jit(), record_jax_normals() as serial_draws:
        default.tts(TEXT)
    assert [d.shape[-1] for d in serial_draws] == [2, 2, 32] * 3
    for i in range(3):
        assert np.array_equal(serial_draws[3 * i], serial_draws[3 * i + 1])  # same rng
    assert [d.shape[-1] for d in draws] == [2, 2, 32]
    assert draws[0].shape[0] == 3 and np.array_equal(draws[0], draws[1])
    # each sentence is followed by the silence gap, and none is silent itself
    assert np.all(want[-SENTENCE_GAP:] == 0)
    assert np.abs(want[: -SENTENCE_GAP]).max() > 0.01


def test_tts_api_matches_jax_synthesizer(model_dir, jax_reference, tmp_path):
    tts = TTS(model_path=str(model_dir), device="cpu")
    assert tts.synthesizer.output_sample_rate == 22050
    with replay_normals(jax_reference[1]):
        wav = tts.tts(TEXT)
    _check_against_jax(wav, jax_reference)
    path = tts.tts_to_file("Be a voice, not an echo.", file_path=str(tmp_path / "out.wav"))
    sr, pcm = scipy.io.wavfile.read(path)
    assert sr == 22050 and len(pcm) > SENTENCE_GAP


def test_synthesizer_from_checkpoint_file_matches_jax(model_dir, jax_reference):
    synth = Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                        tts_config_path=str(model_dir / "config.json"), device="cpu")
    with replay_normals(jax_reference[1]):
        wav = synth.tts(TEXT)
    _check_against_jax(wav, jax_reference)


def test_checkpoint_file_needs_its_config(model_dir):
    with pytest.raises(ValueError, match="config"):
        Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"), device="cpu")


def test_device_defaults_to_cuda(model_dir):
    """No silent CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTS(model_path=str(model_dir))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                    tts_config_path=str(model_dir / "config.json"))


def test_single_speaker_model_takes_no_speaker(model_dir):
    synth = Synthesizer(model_dir=str(model_dir), device="cpu")
    with pytest.raises(ValueError, match="speaker_name"):
        synth.tts("Hello there.", speaker_name="p225")
    with pytest.raises(NotImplementedError, match="no streaming path"):
        next(synth.tts_stream("Hello there."))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_answers_vits_requests(model_dir):
    """Two concurrent ``/api/tts`` requests under the server's lock, each a
    RIFF body holding exactly the synthesizer's samples for its text."""
    synth = Synthesizer(model_dir=str(model_dir), device="cpu")
    texts = ["Be a voice, not an echo.", "The 3 cats ate at 10:30. Then they slept."]
    want = {t: np.asarray(synth.tts(t), np.float32) for t in texts}
    srv = create_server(synth, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    bodies = {}
    try:
        threads = [threading.Thread(
            target=lambda t=t: bodies.__setitem__(
                t, _get(f"{base}/api/tts?text={urllib.parse.quote(t)}")))
            for t in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert all(not th.is_alive() for th in threads)
        stream = _get(f"{base}/api/tts-stream?text=hello")
        speaker = _get(f"{base}/api/tts?text=hello&speaker_id=p225")
    finally:
        close_server(srv)
    for t in texts:
        code, body = bodies[t]
        assert code == 200 and body[:4] == b"RIFF"
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        assert sr == 22050 and pcm.dtype == np.int16
        assert pcm.shape == want[t].shape
        scaled = want[t] * (32767 / max(0.01, float(np.abs(want[t]).max())))
        np.testing.assert_allclose(pcm, scaled, rtol=0, atol=1.0)
    assert stream[0] == 501 and b"no streaming path" in stream[1]
    assert speaker[0] == 400
