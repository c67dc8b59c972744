"""Bark through the port's surfaces, against the JAX package on the CPU:
``Bark.synthesize`` at random and from a voice prompt (a dict and an
``.npz`` of ``voice_dir``), the ``Synthesizer`` and ``TTS`` on a bark
directory in the reference layout against the JAX ``Synthesizer``, ``tts
--voice_dir --speaker_idx``, ``/api/tts``, and the faults F49 and F50.

The small model of ``test_torch_bark``. Every draw is an argmax in both
packages (``all_greedy``: the AR stages' ``sample_logits`` and the fine
stage's categorical draw), so the codes of the three stages are exact and
the waveform is held within 1e-4 of its peak (fp32).

The directory holds ``text_2.pt``, ``coarse_2.pt``, ``fine_2.pt``
(``{"model": state, "model_args": ...}`` in nanoGPT's names),
``encodec_24khz.pth`` (HF ``EncodecModel``'s names) and ``config.json``,
written by the port's reference-layout writers. The command line and the
server run the default 8 s budget, so their directory's semantic head is
set to emit EOS first for their sentence (``stopping``).
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
import transformers
from test_torch_bark import greedy, jax_tiny, port_of, voice_prompt, write_bark_dir
from test_torch_tortoise import peak_close

from tts_tpu.models.bark import model as jax_model
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.bark import model as bark
from tts_tpu_torch.server.server import build_parser, close_server, server_from_args

TEXT = "Hello there."
FAST = dict(max_gen_duration_s=0.5)  # 24 semantic tokens: 36 coarse frames, one fine window


@contextlib.contextmanager
def all_greedy():
    """``greedy()``, and the fine stage's categorical draws as an argmax;
    the JAX package's BERT tokenizer unavailable (the bytes, F50)."""
    categorical, port_categorical = jax.random.categorical, bark._categorical
    bert = transformers.BertTokenizer.from_pretrained

    def no_bert(*args, **kwargs):
        raise OSError("no local bert-base-multilingual-cased")

    jax.random.categorical = lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis)
    bark._categorical = lambda logits, generator: torch.argmax(logits, dim=-1)
    transformers.BertTokenizer.from_pretrained = no_bert
    try:
        with greedy():
            yield
    finally:
        jax.random.categorical, bark._categorical = categorical, port_categorical
        transformers.BertTokenizer.from_pretrained = bert


@torch.no_grad()
def stopping(pm, text):
    """``pm`` with the semantic head's EOS row set along the last hidden
    state of ``text``'s prompt (random voice), so that EOS is the first
    token sampled for that text (logit 50 against ~N(0, 1) for the others)."""
    seen = {}
    hook = pm.semantic_model.core.register_forward_hook(
        lambda m, args, out: seen.setdefault("h", out[0, -1]))
    pm.semantic_model(pm.semantic_prompt(bark.text_ids(text)), merge_context=True)
    hook.remove()
    h = seen["h"]
    pm.semantic_model.lm_head.weight[pm.config.SEMANTIC_VOCAB_SIZE] = h * (50.0 / h.dot(h))
    return pm


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and the port's on the same weights, the port's written
    as a reference-layout directory (and a stopping copy), and a voice
    folder holding ``alice.npz``."""
    root = tmp_path_factory.mktemp("bark_slice")
    jm = jax_tiny(tmp_path=root)
    pm = port_of(jm)
    write_bark_dir(root / "bark", pm)
    write_bark_dir(root / "stopping", stopping(port_of(jm), TEXT))
    write_bark_dir(root / "no_encodec", pm, with_encodec=False)
    voices = root / "voices"
    voices.mkdir()
    np.savez(voices / "alice.npz", **voice_prompt())
    return jm, pm, root, voices


@pytest.mark.parametrize("voice", ["random", "prompt", "npz"])
def test_synthesize_matches_jax(setup, voice):
    """The three stages' codes equal, the waveform within 1e-4 of its peak:
    the random voice, a prompt dict, and ``voice_dirs/alice.npz``."""
    jm, pm, _, voices = setup
    kw = {"random": {}, "prompt": {"history_prompt": voice_prompt()},
          "npz": {"speaker_id": "alice", "voice_dirs": str(voices)}}[voice]
    jm._jit_cache.clear()
    with all_greedy():
        want = jm.synthesize(TEXT, jm.config, rng=jax.random.PRNGKey(0), **kw, **FAST)
        got = pm.synthesize(TEXT, pm.config, **kw, **FAST)
    jm._jit_cache.clear()
    for k in ("semantic", "coarse", "fine"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["fine"].shape[1] == got["coarse"].shape[1] == 36
    assert got["wav"].shape == want["wav"].shape == (36 * 8,)
    peak_close(got["wav"], want["wav"], 1e-4, "wav")


def test_synthesizer_and_tts_match_the_jax_synthesizer(setup, tmp_path):
    """``TTS(model_path=dir, voice_dir=...)`` and the ``Synthesizer``
    against the JAX ``Synthesizer`` on the same directory: two sentences
    in alice's voice, each followed by 10000 zero samples. F52: the
    directory's ``config.json`` comes from the JAX ``BarkConfig``, whose
    audio section says 22,050 Hz; the JAX ``Synthesizer`` labels the 24 kHz
    audio with it, the port with its ``output_sample_rate``, 24 kHz (the
    reference's ``BarkAudioConfig``)."""
    jm, _, root, voices = setup
    shutil.copytree(root / "bark", tmp_path / "jax")  # the JAX loader writes beside
    text = "Hello there. Be a voice!"
    with all_greedy():
        theirs = JaxSynthesizer(model_dir=str(tmp_path / "jax"), voice_dir=str(voices))
        want = np.asarray(theirs.tts(text, speaker_name="alice", **FAST), np.float32)
        tts = TTS(model_path=str(root / "bark"), voice_dir=str(voices), device="cpu")
        got = np.asarray(tts.tts(text, speaker="alice", **FAST), np.float32)
    assert tts.synthesizer.output_sample_rate == 24000 and theirs.output_sample_rate == 22050
    assert got.shape == want.shape == (2 * (36 * 8 + 10000),)
    assert (got[36 * 8: 36 * 8 + 10000] == 0).all() and (got[-10000:] == 0).all()
    peak_close(got, want, 1e-4, "two sentences")
    assert not tts.is_multi_speaker and tts.speakers == []


def test_command_line_voice_dir_and_speaker_idx(setup, tmp_path):
    """``tts --model_path --voice_dir --speaker_idx alice`` writes the
    samples of ``TTS.tts_to_file`` (within one int16 step) at 24 kHz; an
    unknown speaker names its missing ``.npz``."""
    _, _, root, voices = setup
    api, cli = tmp_path / "api.wav", tmp_path / "cli.wav"
    tts = TTS(model_path=str(root / "stopping"), voice_dir=str(voices), device="cpu")
    tts.tts_to_file(TEXT, speaker="alice", file_path=str(api))
    with contextlib.redirect_stdout(io.StringIO()):
        port_cli(["--text", TEXT, "--model_path", str(root / "stopping"), "--voice_dir",
                  str(voices), "--speaker_idx", "alice", "--out_path", str(cli), "--device",
                  "cpu"])
    (sr_a, a), (sr_c, c) = scipy.io.wavfile.read(api), scipy.io.wavfile.read(cli)
    assert sr_a == sr_c == 24000 and a.shape == c.shape
    assert np.abs(a.astype(np.int32) - c.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError, match="bob.npz"):
        tts.tts(TEXT, speaker="bob")


def test_stopping_head_stops_at_the_first_token(setup):
    """The surfaces' directory: EOS is the first semantic token for the
    sentence, so the default budget costs one coarse frame pair."""
    _, pm, root, _ = setup
    stopped = bark.Bark(pm.config).load_checkpoint(checkpoint_dir=str(root / "stopping"),
                                                   device="cpu")
    out = stopped.synthesize(TEXT, stopped.config)
    assert len(out["semantic"]) == 0 and out["coarse"].shape == (2, 1)
    assert out["wav"].shape == (8,) and np.isfinite(out["wav"]).all()


def test_server_answers_api_tts_serially(setup):
    """``/api/tts`` on a bark directory (the random voice; the server takes
    no voice directory, as the JAX server) answers with the audio of
    ``TTS.tts`` at 24 kHz."""
    _, _, root, _ = setup
    args = build_parser().parse_args(["--model_path", str(root / "stopping"), "--port", "0",
                                      "--max_batch", "4", "--device", "cpu"])
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
    wav = np.asarray(TTS(model_path=str(root / "stopping"), device="cpu").tts(TEXT), np.float32)
    want = (wav * (32767 / max(0.01, float(np.abs(wav).max())))).astype(np.int16)
    assert sr == 24000 and pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_f49_no_encodec_raises_before_generating(setup, tmp_path):
    """F49: without an EnCodec file the port's ``synthesize`` raises naming
    the fault before any stage runs; the JAX ``synthesize`` returns
    ``wav=None`` after all three stages, and its ``Synthesizer`` fails on
    it with a ``TypeError``."""
    _, _, root, _ = setup
    tts = TTS(model_path=str(root / "no_encodec"), device="cpu")
    model = tts.synthesizer.tts_model
    assert model.encodec is None
    steps = model.semantic_model.decode_steps
    with pytest.raises(RuntimeError, match=r"encodec_24khz\.pth.*F49"):
        tts.tts(TEXT)
    assert model.semantic_model.decode_steps == steps
    shutil.copytree(root / "no_encodec", tmp_path / "jax")
    theirs = JaxSynthesizer(model_dir=str(tmp_path / "jax"))
    out = theirs.tts_model.synthesize(TEXT, theirs.tts_config, max_gen_duration_s=0.1)
    assert out["wav"] is None and "encodec" in out["decode_error"]
    with pytest.raises(TypeError):
        theirs.tts(TEXT, max_gen_duration_s=0.1)


def test_f50_text_is_always_utf8_bytes(setup, monkeypatch):
    """F50: the JAX ``synthesize`` takes ``bert-base-multilingual-cased``'s
    ids where ``transformers`` finds it in a local cache, else the UTF-8
    bytes; the port always takes the bytes (neither the vocabulary nor
    ``transformers`` is the port's)."""
    jm, pm, _, _ = setup
    seen = {}

    class Bert:
        def encode(self, text, add_special_tokens=False):
            return [7, 8, 9]

    monkeypatch.setattr(transformers.BertTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **kw: Bert()))

    def record(name):
        def stage(text_tokens, *args, **kwargs):
            seen[name] = list(np.asarray(text_tokens))
            raise StopIteration
        return stage

    monkeypatch.setattr(jm, "generate_text_semantic", record("jax"))
    monkeypatch.setattr(pm, "generate_text_semantic", record("port"))
    for model, cfg in ((jm, jm.config), (pm, pm.config)):
        with pytest.raises(StopIteration):
            model.synthesize("héllo", cfg)
    assert seen["jax"] == [7, 8, 9]
    assert seen["port"] == list("héllo".encode("utf-8"))
