"""The port's XTTS serving slice end to end against the JAX package.

One tiny model directory (``helpers.tiny_xtts_config``: 2 layers, 64 wide)
holds ``config.json`` with greedy sampling (top_k=1), a character
``vocab.json`` written by the port's tokenizer helper, the JAX package's
``model_flax.msgpack`` and the port's ``model_torch.pt`` carrying the same
weights, and a reference wav. The JAX ``Synthesizer`` and the port's ``TTS``
/ ``Synthesizer`` / HTTP server (``/api/tts-stream`` through the
``StreamBatcher``, ``/api/tts``) each load it on the CPU and clone the same
voice. Greedy decoding makes the token streams identical; the audio agrees
within 1e-4 (fp32 through conditioning, 2 GPT layers and the HiFi decoder),
plus one int16 step where it crossed the server.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys
import threading
import urllib.parse
import urllib.request

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_init_model, tiny_xtts_config

from tts_tpu_torch.api import TTS
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
from tts_tpu_torch.server.server import close_server, create_server
from tts_tpu_torch.utils.convert import xtts_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
PCM_STEP = 1.0 / 32767
TEXTS = ["hello there.", "hello where."]  # same token count: batching cannot pad either
STREAM_CHUNK = 20  # tokens per streamed chunk (the default)
OVERLAP = 1024  # crossfaded samples between chunks (the default)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tts_tpu.audio.numpy_transforms import save_wav
    from tts_tpu.models.xtts import Xtts as JaxXtts
    from tts_tpu.utils.io import save_checkpoint

    d = tmp_path_factory.mktemp("xtts_slice")
    config = tiny_xtts_config()
    config.top_k = 1  # greedy
    jm = JaxXtts(config)
    gpt_params, decoder_params = fast_init_model(
        jm, jax.random.PRNGKey(0), attrs=("gpt_params", "decoder_params"), scale=0.04
    )
    # a random model may sample the stop token at once; make it never do so,
    # so that every stream runs several chunks (crossfades included)
    gpt_params = flax.core.unfreeze(gpt_params)
    head = gpt_params["params"]["mel_head"]
    head["bias"] = jnp.asarray(head["bias"]).at[config.model_args.gpt_stop_audio_token].set(-1e4)
    save_checkpoint(str(d / "model_flax.msgpack"),
                    {"gpt": gpt_params, "decoder": decoder_params, "mel_stats": np.zeros((0,))},
                    config=config)
    with open(d / "config.json", "w") as f:
        json.dump(config.to_dict(), f, default=str)
    write_char_vocab(str(d / "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'")

    port = Xtts(XttsConfig.from_dict(config.to_dict()))
    port.load_state_dict_with_stats(xtts_from_jax_params(gpt_params, decoder_params))
    torch.save(port.state_dict_with_stats(), d / "model_torch.pt")

    rs = np.random.RandomState(0)
    t = np.arange(33075, dtype=np.float32) / 22050.0
    save_wav(wav=0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rs.randn(len(t)).astype(np.float32),
             path=str(d / "ref.wav"), sample_rate=22050)
    return d


@pytest.fixture(scope="module")
def jax_synth(model_dir):
    from tts_tpu.utils.synthesizer import Synthesizer

    return Synthesizer(model_dir=str(model_dir))


@pytest.fixture(scope="module")
def jax_reference(model_dir, jax_synth):
    """The JAX package's outputs for TEXTS: streamed chunks and full wavs."""
    synth = jax_synth
    ref = str(model_dir / "ref.wav")
    stream = {t: [np.asarray(c, np.float32) for c in
                  synth.tts_stream(t, language_name="en", speaker_wav=ref)] for t in TEXTS}
    full = np.asarray(synth.tts(TEXTS[0], language_name="en", speaker_wav=ref), np.float32)
    return stream, full


@pytest.fixture(scope="module")
def port_tts(model_dir):
    return TTS(model_path=str(model_dir), device="cpu")


def test_device_defaults_to_cuda(model_dir):
    """No silent CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTS(model_path=str(model_dir))


def test_tts_stream_matches_jax(port_tts, model_dir, jax_synth, jax_reference):
    """ROADMAP.md F5: the port's stream stops at ``max_mel_tokens - 3``
    tokens (61 here), the bound of the non-streaming decode, and cuts its
    last chunk short (one token); the JAX stream rounds up to whole chunks
    (80 tokens), so its last positions pass the 67-row position table,
    which its ``dynamic_slice`` clamps. Up to the cut the two streams are
    the same: every whole chunk within 1e-4 of the JAX one, and the short
    last chunk is the JAX decoder's audio for the same latents, crossfaded
    with the chunk before as the JAX stream crossfades."""
    stream, _ = jax_reference
    model = port_tts.synthesizer.tts_model
    vocoded = []
    real = model.hifigan_decoder.forward

    def recording(latents, speaker_embedding, *args, **kwargs):
        vocoded.append((latents.numpy().copy(), speaker_embedding.numpy().copy()))
        return real(latents, speaker_embedding, *args, **kwargs)

    model.hifigan_decoder.forward = recording
    try:
        chunks = list(port_tts.tts_stream(TEXTS[0], language="en",
                                          speaker_wav=str(model_dir / "ref.wav")))
    finally:
        del model.hifigan_decoder.forward
    want = stream[TEXTS[0]]
    max_new = model.gpt.max_mel_tokens - 3
    n_last = max_new % STREAM_CHUNK
    assert n_last and len(chunks) == len(want) == -(-max_new // STREAM_CHUNK) >= 3
    assert [lat.shape[1] for lat, _ in vocoded] == [STREAM_CHUNK] * (len(chunks) - 1) + [n_last]
    for got, w in zip(chunks[:-1], want[:-1]):
        assert got.shape == w.shape
        np.testing.assert_allclose(got, w, atol=ATOL)
    jm = jax_synth.tts_model
    latents, spk = vocoded[-1]
    last = np.asarray(jm.hifigan_decoder.apply(jm.decoder_params, jnp.asarray(latents),
                                               jnp.asarray(spk)), np.float32)[0, :, 0].copy()
    fade = np.linspace(0, 1, OVERLAP, dtype=np.float32)
    last[:OVERLAP] = last[:OVERLAP] * fade + want[-2][-OVERLAP:] * (1 - fade)
    assert chunks[-1].shape == last.shape and want[-1].shape[0] > last.shape[0]
    np.testing.assert_allclose(chunks[-1], last, atol=ATOL)
    audio = np.abs(np.concatenate(want))
    assert 0.05 < audio.max() and np.mean(audio > 0.99) < 0.01  # neither silent nor clipped


def test_tts_matches_jax(port_tts, model_dir, jax_reference, tmp_path):
    _, full = jax_reference
    wav = np.asarray(port_tts.tts(TEXTS[0], language="en",
                                  speaker_wav=str(model_dir / "ref.wav")), np.float32)
    assert wav.shape == full.shape
    np.testing.assert_allclose(wav, full, atol=ATOL)
    out = port_tts.tts_to_file(TEXTS[0], language="en", speaker_wav=str(model_dir / "ref.wav"),
                               file_path=str(tmp_path / "out.wav"))
    assert os.path.getsize(out) > 44


def test_speaker_bank_speaks_like_its_clip(port_tts, model_dir, tmp_path):
    """A ``speakers_xtts.pth`` entry (reference layout: latents ``[1, 32, D]``,
    d-vector ``[1, 512, 1]``) saved from a clip's conditioning synthesizes
    what the clip does; an unknown name raises."""
    ref = str(model_dir / "ref.wav")
    synth = port_tts.synthesizer
    cond, spk = synth.tts_model.resolve_conditioning(synth.tts_config, speaker_wav=ref)
    for name in ("config.json", "vocab.json", "model_torch.pt"):
        (tmp_path / name).symlink_to(model_dir / name)
    torch.save({"voice": {"gpt_cond_latent": cond, "speaker_embedding": spk[..., None]}},
               tmp_path / "speakers_xtts.pth")
    banked = TTS(model_path=str(tmp_path), device="cpu")
    want = np.asarray(port_tts.tts(TEXTS[0], language="en", speaker_wav=ref), np.float32)
    got = np.asarray(banked.tts(TEXTS[0], speaker="voice", language="en"), np.float32)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Unknown XTTS speaker"):
        banked.tts(TEXTS[0], speaker="nobody", language="en")


def test_cli_clones_a_voice_like_jax(model_dir, jax_reference, tmp_path, capsys):
    """``tts --speaker_wav … --language_idx en`` writes the JAX synthesizer's
    audio as a peak-normalised 16-bit wav. A model with several built-in
    speakers needs ``--speaker_idx`` or ``--speaker_wav``."""
    import scipy.io.wavfile

    from tts_tpu_torch.bin.synthesize import main as cli

    _, full = jax_reference
    out = tmp_path / "cli.wav"
    cli(["--text", TEXTS[0], "--model_path", str(model_dir), "--speaker_wav",
         str(model_dir / "ref.wav"), "--language_idx", "en", "--out_path", str(out),
         "--device", "cpu"])
    sr, pcm = scipy.io.wavfile.read(out)
    want = full * (32767 / max(0.01, float(np.abs(full).max())))
    assert sr == 24000 and pcm.shape == want.shape
    np.testing.assert_allclose(pcm, want, atol=1.0 + ATOL * 32767 / np.abs(full).max())

    banked = tmp_path / "banked"
    banked.mkdir()
    for name in ("config.json", "vocab.json", "model_torch.pt"):
        (banked / name).symlink_to(model_dir / name)
    spk = TTS(model_path=str(model_dir), device="cpu").synthesizer.tts_model.resolve_conditioning(
        XttsConfig(), speaker_wav=str(model_dir / "ref.wav"))
    entry = {"gpt_cond_latent": spk[0], "speaker_embedding": spk[1][..., None]}
    torch.save({"one": entry, "two": entry}, banked / "speakers_xtts.pth")
    args = ["--text", TEXTS[0], "--model_path", str(banked), "--language_idx", "en",
            "--out_path", str(tmp_path / "banked.wav"), "--device", "cpu"]
    with pytest.raises(SystemExit) as exit_info:
        cli(args)
    assert exit_info.value.code == 1 and "multi-speaker model" in capsys.readouterr().err
    cli(args + ["--speaker_idx", "two"])
    assert np.array_equal(scipy.io.wavfile.read(tmp_path / "banked.wav")[1], pcm)


def _fetch(url, bodies, key):
    with urllib.request.urlopen(url, timeout=120) as r:
        bodies[key] = (r.status, r.read())


def test_server_streams_through_batcher_and_matches_jax(port_tts, model_dir, jax_reference):
    stream, full = jax_reference
    synth = port_tts.synthesizer
    batch_sizes = []
    real = synth.tts_model.inference_stream_batched

    def spy(texts, *args, **kwargs):
        batch_sizes.append(len(texts))
        return real(texts, *args, **kwargs)

    synth.tts_model.inference_stream_batched = spy
    srv = create_server(synth, port=0, stream_batch=2, stream_window_ms=300)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    ref = urllib.parse.quote(str(model_dir / "ref.wav"))
    bodies = {}
    try:
        threads = [
            threading.Thread(target=_fetch, args=(
                f"{base}/api/tts-stream?text={urllib.parse.quote(t)}&language_id=en&speaker_wav={ref}",
                bodies, t))
            for t in TEXTS
        ]
        threads.append(threading.Thread(target=_fetch, args=(
            f"{base}/api/tts?text={urllib.parse.quote(TEXTS[0])}&language_id=en&speaker_wav={ref}",
            bodies, "full")))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert all(not th.is_alive() for th in threads)
        status, index = [], None
        with urllib.request.urlopen(f"{base}/", timeout=30) as r:
            status.append(r.status)
            index = r.read()
    finally:
        close_server(srv)
        del synth.tts_model.inference_stream_batched

    assert status == [200] and b"tts_tpu_torch" in index
    assert sorted(batch_sizes) and sum(batch_sizes) == len(TEXTS)
    for t in TEXTS:
        code, body = bodies[t]
        assert code == 200 and body[:4] == b"RIFF"
        pcm = np.frombuffer(body[44:], dtype="<i2").astype(np.float32) / 32767
        # F5: the JAX stream's whole chunks, then the port's short last chunk
        # (held against the JAX decoder in test_tts_stream_matches_jax)
        last = list(port_tts.tts_stream(t, language="en",
                                        speaker_wav=str(model_dir / "ref.wav")))[-1]
        want = np.clip(np.concatenate(stream[t][:-1] + [last]), -1, 1)
        assert pcm.shape == want.shape
        np.testing.assert_allclose(pcm, want, atol=ATOL + PCM_STEP)
    code, body = bodies["full"]
    assert code == 200 and body[:4] == b"RIFF"
    pcm = np.frombuffer(body[44:], dtype="<i2").astype(np.float32)
    want = full * (32767 / max(0.01, float(np.abs(full).max())))
    assert pcm.shape == want.shape
    np.testing.assert_allclose(pcm, want, atol=1.0 + ATOL * 32767 / np.abs(full).max())


def test_port_imports_no_jax_flax_or_tokenizers():
    """The port imports nothing of ``tts_tpu`` (not even its jax-free
    modules), nor ``jax``, ``flax``, ``tokenizers`` or ``transformers``. Checked in a fresh
    interpreter, after importing every module of the port, the XTTS and VITS
    slices, the phonemizers, the ``tts`` command line, the server, its
    batcher, the pack planner, the speaker and language managers, the zoo
    manager, the iSTFT decoder and the PQMF bank, GlowTTS with its flows, the
    MelGAN generators, the vocoder registry and configs, the
    ``AudioProcessor``, Tacotron2 with its layers, the speaker encoders,
    the ForwardTTS family with its feed-forward layers, Overflow and
    NeuralHMM, AlignTTS and DelightfulTTS, the ParallelWaveGAN, UnivNet,
    WaveGrad and WaveRNN vocoders, the GST and Capacitron layers,
    Tacotron v1, FreeVC with WavLM (``vc/``), Tortoise with its wav2vec aligner, Bark,
    and the training side (the data pipeline, the trainer with its callbacks
    and loggers, checkpoint files, ``train_tts``) included: this test process
    has JAX and ``tts_tpu`` loaded already (tests/conftest.py). The zoo
    manager reads the port's own catalog, no file under ``tts_tpu/``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tts_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tts_tpu_torch.__path__, 'tts_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from tts_tpu_torch.utils.convert import load_reference_vits, load_reference_xtts\n"
        "import tts_tpu_torch.models.vits.model, tts_tpu_torch.utils.synthesis\n"
        "import tts_tpu_torch.text.phonemizers, tts_tpu_torch.text.en_g2p\n"
        "import tts_tpu_torch.text.latin_g2p, tts_tpu_torch.bin.synthesize\n"
        "import tts_tpu_torch.server.server, tts_tpu_torch.server.batching\n"
        "import tts_tpu_torch.utils.packing, tts_tpu_torch.utils.managers\n"
        "from tts_tpu_torch.utils.manage import ModelManager\n"
        "import tts_tpu_torch.vocoder.layers, tts_tpu_torch.vocoder.models.istft_hifigan\n"
        "assert len(mods) > 58 and 'tts_tpu_torch.text.japanese' in mods, mods\n"
        "assert {'tts_tpu_torch.utils.manage', 'tts_tpu_torch.vocoder.layers',\n"
        "        'tts_tpu_torch.vocoder.models.istft_hifigan'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import load_reference_glow_tts, load_reference_vocoder\n"
        "assert {'tts_tpu_torch.models.glow_tts.model', 'tts_tpu_torch.layers.glow',\n"
        "        'tts_tpu_torch.vocoder.models.melgan_generator', 'tts_tpu_torch.vocoder.utils',\n"
        "        'tts_tpu_torch.vocoder.configs', 'tts_tpu_torch.audio.processor'} <= set(mods), mods\n"
        "catalog = ModelManager().models_file\n"
        "assert catalog.endswith('tts_tpu_torch/zoo/models.json'), catalog\n"
        "assert 'tts_tpu_torch.utils.managers' in mods, mods\n"
        "assert 'tts_tpu_torch.bin.synthesize' in mods, mods\n"
        "assert 'tts_tpu_torch.models.vits.model' in mods, mods\n"
        "assert {'tts_tpu_torch.utils.packing', 'tts_tpu_torch.server.batching'} <= set(mods)\n"
        "from tts_tpu_torch.utils.convert import load_reference_tacotron2\n"
        "assert {'tts_tpu_torch.models.tacotron2.model', 'tts_tpu_torch.layers.tacotron',\n"
        "        'tts_tpu_torch.models.base'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import load_reference_forward_tts, load_reference_speaker_encoder\n"
        "assert {'tts_tpu_torch.models.forward_tts.model', 'tts_tpu_torch.layers.feed_forward',\n"
        "        'tts_tpu_torch.encoder.model', 'tts_tpu_torch.encoder.configs'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import load_reference_overflow, delightful_tts_from_jax_params\n"
        "assert {'tts_tpu_torch.models.overflow.model', 'tts_tpu_torch.models.align_tts.model',\n"
        "        'tts_tpu_torch.models.delightful_tts.model',\n"
        "        'tts_tpu_torch.models.delightful_tts.acoustic_model'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import convert_wavernn, reference_univnet_state\n"
        "assert {'tts_tpu_torch.vocoder.models.parallel_wavegan_generator',\n"
        "        'tts_tpu_torch.vocoder.models.univnet_generator',\n"
        "        'tts_tpu_torch.vocoder.models.wavegrad',\n"
        "        'tts_tpu_torch.vocoder.models.wavernn'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import convert_gst, convert_capacitron\n"
        "assert {'tts_tpu_torch.layers.tacotron_v1', 'tts_tpu_torch.layers.capacitron',\n"
        "        'tts_tpu_torch.models.tacotron2.tacotron_v1'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import load_reference_freevc, load_reference_wavlm\n"
        "assert {'tts_tpu_torch.vc.configs', 'tts_tpu_torch.vc.modules.wavlm',\n"
        "        'tts_tpu_torch.vc.models.freevc', 'tts_tpu_torch.vc.models'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import convert_unified_voice, reference_clvp_state\n"
        "assert {'tts_tpu_torch.models.tortoise.model', 'tts_tpu_torch.models.tortoise.layers',\n"
        "        'tts_tpu_torch.models.tortoise.tokenizer',\n"
        "        'tts_tpu_torch.models.tortoise.audio'} <= set(mods), mods\n"
        "from tts_tpu_torch.utils.convert import load_reference_encodec, convert_bark_gpt\n"
        "assert {'tts_tpu_torch.models.bark.model', 'tts_tpu_torch.models.bark.encodec',\n"
        "        'tts_tpu_torch.models.bark.hubert',\n"
        "        'tts_tpu_torch.models.tortoise.wav2vec_alignment'} <= set(mods), mods\n"
        "assert {'tts_tpu_torch.data', 'tts_tpu_torch.data.dataset', 'tts_tpu_torch.data.formatters',\n"
        "        'tts_tpu_torch.data.samplers', 'tts_tpu_torch.trainer.trainer',\n"
        "        'tts_tpu_torch.trainer.callbacks', 'tts_tpu_torch.trainer.logging',\n"
        "        'tts_tpu_torch.utils.io', 'tts_tpu_torch.utils.generic', 'tts_tpu_torch.utils.visual',\n"
        "        'tts_tpu_torch.bin.train_tts'} <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'tokenizers', 'tts_tpu',\n"
        "                                             'transformers')\n"
        "             or m.startswith('tts_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
