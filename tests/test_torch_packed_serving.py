"""The port's batched VITS serving against the JAX package, on the CPU: the
pack planner (``utils/packing.py``), the sequence-packed decode
(``Vits.inference_packed``), packed multi-sentence requests in the
``Synthesizer`` and the server's ``DynamicBatcher``.

A tiny model (``test_torch_vits_model.tiny_vits_args``: hidden 32, 2
layers; graphemes with ``english_cleaners`` and blanks) is saved as the JAX
package's ``model.msgpack`` and the port's ``model_torch.pt`` with the same
weights. The JAX runs are made with jit disabled and their
``jax.random.normal`` draws replayed into the port, so durations must be
equal and waveforms agree within 1e-4. The JAX package bills packed rows in
eights (``row_pad_multiple=8``), the port by ``ROW_PAD_MULTIPLE``: every
comparison plans both with the port's value (``jax_packing_as_port``), so
the two decode the same layout.

Divergences from the JAX package, each named in its test:

* F1: the JAX ``Synthesizer`` reaches its packed path only with
  ``use_griffin_lim=False``; the port packs every multi-sentence VITS
  request.
* F2: ``supports_packed_decode`` is false for the ``istft`` decoder and
  where ``interpolate_z`` applies; the JAX package checks only ``istft``.
* F3: packed lengths are capped at ``max_inference_len`` as well as at the
  frame budget; the JAX batcher and ``Synthesizer`` cap at the budget only.
* No silent fallback: an error in a packed decode reaches the caller.

F9: the port's ``Synthesizer`` trims each sentence's trailing silence
exactly where the JAX one does, a model loaded from a checkpoint file whose
audio config has ``do_trim_silence`` on; a VITS config's audio section has
no such field, so as loaded neither package trims VITS.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import functools
import io
import json
import sys
import threading
import types
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from helpers import tiny_xtts_config
from test_torch_vits_model import (
    port_of,
    record_jax_normals,
    replay_normals,
    tiny_jax_vits,
)

import tts_tpu.utils.packing as jax_packing
from tts_tpu.server.batching import DynamicBatcher as JaxDynamicBatcher
from tts_tpu.server.batching import _Pending as JaxPending
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.models.vits.model import supports_packed_decode
from tts_tpu_torch.server import batching
from tts_tpu_torch.server.batching import DynamicBatcher
from tts_tpu_torch.server.server import close_server, create_server
from tts_tpu_torch.utils import packing
from tts_tpu_torch.utils.convert import vits_from_jax_params
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences

ATOL = 1e-4
HOP = 16  # tiny_vits_args: upsample 4 x 4
TEXT = "The 3 cats ate at 10:30. Be a voice, not an echo! Prior to November 22, 1963."
SENTENCES = ["The 3 cats ate at 10:30.", "Be a voice, not an echo!",
             "Prior to November 22, 1963."]
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)


@contextlib.contextmanager
def jax_packing_as_port():
    """The JAX package plans packed grids with the port's row billing."""
    orig = jax_packing.plan_pack_layout
    jax_packing.plan_pack_layout = functools.partial(
        orig, row_pad_multiple=packing.ROW_PAD_MULTIPLE)
    try:
        yield
    finally:
        jax_packing.plan_pack_layout = orig


@contextlib.contextmanager
def jax_eager_draws():
    """Jit off, the port's row billing, and every JAX normal draw recorded."""
    with jax.disable_jit(), jax_packing_as_port(), record_jax_normals() as draws:
        yield draws


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tts_tpu.utils.io import save_checkpoint

    d = tmp_path_factory.mktemp("vits_packed")
    jm, params = tiny_jax_vits(seed=4, config_kw=RECIPE, num_chars=100)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    port = Vits(VitsConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(vits_from_jax_params(params))
    torch.save(port.module.state_dict(), d / "model_torch.pt")
    return d


def jax_synth(model_dir, **kwargs):
    return JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                          tts_config_path=str(model_dir / "config.json"), **kwargs)


def port_synth(model_dir):
    return Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                       tts_config_path=str(model_dir / "config.json"), device="cpu")


@pytest.fixture(scope="module")
def pair():
    jm, params = tiny_jax_vits(seed=5)
    return jm, params, port_of(jm, params)


def _ids(seed=0, B=3, T=16):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, 48, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 5, T - 10][:B], np.int32)
    return x, lengths


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() for a in arrays]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_pad_multiple", [8, 1])
def test_plan_and_unpack_match_jax(row_pad_multiple):
    """Seeded random length sets, one to twelve utterances: every field of
    the plan, and the unpacked slices of a random grid, equal the JAX
    package's."""
    rs = np.random.RandomState(row_pad_multiple)
    for trial in range(40):
        lens = rs.randint(1, 700, rs.randint(1, 13))
        kw = dict(row_pad_multiple=row_pad_multiple)
        if trial % 4 == 3:
            kw.update(gap=4, len_multiple=32)
        got, want = packing.plan_pack_layout(lens, **kw), jax_packing.plan_pack_layout(lens, **kw)
        np.testing.assert_array_equal(got.seg_sample, want.seg_sample)
        np.testing.assert_array_equal(got.seg_pos, want.seg_pos)
        assert (got.slices, got.row_len, got.n_rows, got.total_frames, got.gap, got.lengths) == (
            want.slices, want.row_len, want.n_rows, want.total_frames, want.gap, want.lengths)
        assert got.utilization == want.utilization
        grid = rs.randn(got.n_rows, got.row_len * 3, 1).astype(np.float32)
        for g, w in zip(packing.unpack_outputs(grid, got, upsample=3),
                        jax_packing.unpack_outputs(grid, want, upsample=3), strict=True):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the packed decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise_layout", ["batch", "packed"])
def test_inference_packed_matches_jax(pair, noise_layout):
    """Durations pass, plan, packed decode: equal durations and lengths,
    the grid's waveform within 1e-4, in both noise layouts."""
    jm, params, port = pair
    x, xl = _ids()
    with record_jax_normals() as draws:
        durations = np.asarray(jm.infer_durations(params, jnp.asarray(x), jnp.asarray(xl)))
        plan = jax_packing.plan_pack_layout(durations, row_pad_multiple=1)
        want = jm.inference_packed(params, jnp.asarray(x), jnp.asarray(xl), plan.seg_sample,
                                   plan.seg_pos, noise_frames=64, noise_layout=noise_layout)
    noise = (3, 64, 32) if noise_layout == "batch" else (plan.n_rows, plan.row_len, 32)
    assert [d.shape for d in draws] == [(3, 16, 2), (3, 16, 2), noise]
    with replay_normals(draws):
        got_durations = port.infer_durations(*_torch(x, xl))
        got = port.inference_packed(*_torch(x, xl), plan.seg_sample, plan.seg_pos,
                                    noise_frames=64, noise_layout=noise_layout)
    np.testing.assert_array_equal(got_durations.numpy(), durations)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["packed_mask"].numpy(), np.asarray(want["packed_mask"]))
    out = got["model_outputs"].numpy()
    assert out.shape == (plan.n_rows, plan.row_len * HOP, 1)
    np.testing.assert_allclose(out, np.asarray(want["model_outputs"]), rtol=0, atol=ATOL)
    assert np.abs(out).max() > 0.05


def masked_decode(port, x, xl, generator_seed, noise_frames, aux=None):
    """Each utterance of ``x`` decoded alone at its own length, with its own
    speaker and language from ``aux`` (``aux_input``), zero-padded by 16
    frames and masked after every layer and conv, on the noise that
    ``inference_packed(noise_layout="batch")`` draws from the same seed."""
    from tts_tpu_torch.models.vits import modules
    from tts_tpu_torch.ops.helpers import generate_path, sequence_mask

    m = port.module
    gen = torch.Generator().manual_seed(generator_seed)
    with torch.no_grad():
        g, lang = m._cond_vectors(aux)
        w_ceil, m_p, logs_p, x_mask = m._durations(x, xl, gen, g, lang)
        noise = modules.normal((x.shape[0], noise_frames, m_p.shape[-1]), gen)
        wavs = []
        for i in range(x.shape[0]):
            frames = int(w_ceil[i].sum())
            y_mask = sequence_mask(torch.tensor([frames]), frames + 16)[:, :, None].float()
            attn = generate_path(w_ceil[i : i + 1, :, 0], x_mask[i : i + 1] * y_mask.transpose(1, 2))
            mean = torch.bmm(attn.transpose(1, 2), m_p[i : i + 1])
            log_scale = torch.bmm(attn.transpose(1, 2), logs_p[i : i + 1])
            eps = torch.zeros_like(mean)
            eps[0, :frames] = noise[i, :frames]
            z_p = (mean + eps * torch.exp(log_scale) * port.args.inference_noise_scale) * y_mask
            g_i = None if g is None else g[i : i + 1]
            z = m.flow(z_p, y_mask, g=g_i)
            wavs.append(m.waveform_decoder(z * y_mask, g=g_i, x_mask=y_mask)[0, : frames * HOP, 0])
    return wavs


def test_packed_segments_equal_their_own_masked_decodes(pair):
    """The grid's masks keep segments apart: each packed segment (batch
    noise layout) equals its utterance decoded alone with masks, interior
    and the last 8 frames alike, for both row billings' layouts."""
    _, _, port = pair
    x, xl = _torch(*_ids(seed=1))
    want = masked_decode(port, x, xl, 0, noise_frames=64)
    durations = port.infer_durations(x, xl).numpy()
    for row_pad_multiple in (8, 1):
        plan = packing.plan_pack_layout(durations, row_pad_multiple=row_pad_multiple)
        grid = port.inference_packed(x, xl, plan.seg_sample, plan.seg_pos, noise_frames=64,
                                     noise_layout="batch")["model_outputs"].numpy()
        pieces = packing.unpack_outputs(grid, plan, upsample=HOP)
        for i, (got, ref) in enumerate(zip(pieces, want, strict=True)):
            ref = ref.numpy()
            tail = 8 * HOP
            assert got.shape[0] == ref.shape[0] > tail
            np.testing.assert_allclose(got[:-tail, 0], ref[:-tail], rtol=0, atol=1e-5,
                                       err_msg=f"segment {i} interior")
            np.testing.assert_allclose(got[-tail:, 0], ref[-tail:], rtol=0, atol=1e-5,
                                       err_msg=f"segment {i} tail")


# ---------------------------------------------------------------------------
# the Synthesizer's packed multi-sentence requests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_packed_reference(model_dir):
    """The JAX ``Synthesizer(use_griffin_lim=False)`` on TEXT, its draws, and
    the number of packed decodes it ran."""
    synth = jax_synth(model_dir, use_griffin_lim=False)
    calls = []
    orig = synth.tts_model.inference_packed
    synth.tts_model.inference_packed = lambda *a, **k: calls.append(1) or orig(*a, **k)
    with jax_eager_draws() as draws:
        wav = np.asarray(synth.tts(TEXT), np.float32)
    return wav, draws, len(calls)


def test_three_sentences_decode_packed_as_the_jax_packed_path(model_dir, jax_packed_reference):
    """F1: the port decodes the three sentences in one packed grid, as the
    JAX ``Synthesizer`` does with ``use_griffin_lim=False``; with its default
    ``use_griffin_lim=True`` the JAX one decodes them one by one."""
    want, draws, jax_packed_calls = jax_packed_reference
    assert jax_packed_calls == 1
    # the durations pass, the decode's own duration noise, the grid's noise
    assert len(draws) == 3 and draws[0].shape == draws[1].shape and draws[0].shape[0] == 3
    with jax.disable_jit(), record_jax_normals() as serial_draws:
        jax_synth(model_dir).tts(TEXT)
    assert len(serial_draws) == 9  # the JAX default: three serial decodes (F1)

    synth = port_synth(model_dir)
    calls = []
    orig = synth.tts_model.inference_packed
    synth.tts_model.inference_packed = lambda *a, **k: calls.append(1) or orig(*a, **k)
    with replay_normals(draws):
        wav = np.asarray(synth.tts(TEXT), np.float32)
    assert calls == [1]
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=0, atol=ATOL)
    assert np.all(wav[-SENTENCE_GAP:] == 0) and np.abs(wav[:-SENTENCE_GAP]).max() > 0.01


def test_one_sentence_keeps_the_serial_loop(model_dir):
    """One sentence is not packed: durations pass and one ``inference``, as
    the JAX package's serial loop."""
    text = SENTENCES[1]
    with jax.disable_jit(), record_jax_normals() as draws:
        want = np.asarray(jax_synth(model_dir, use_griffin_lim=False).tts(text), np.float32)
    assert [d.shape[-1] for d in draws] == [2, 2, 32]
    synth = port_synth(model_dir)
    synth.tts_model.inference_packed = None  # would raise if called
    with replay_normals(draws):
        wav = np.asarray(synth.tts(text), np.float32)
    np.testing.assert_allclose(wav, want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the DynamicBatcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batchers(model_dir):
    jax_b = JaxDynamicBatcher(jax_synth(model_dir, use_griffin_lim=False), max_batch=4)
    port_b = DynamicBatcher(port_synth(model_dir), max_batch=4)
    yield jax_b, port_b
    jax_b.close()
    port_b.close()


@pytest.mark.parametrize("n", [1, 3])
def test_dispatch_matches_jax_batcher(batchers, n):
    """A fixed batch of ``n`` sentences through each batcher's
    ``_dispatch``: three are padded to four rows and packed, one decodes
    through ``inference`` at its frame budget."""
    jax_b, port_b = batchers
    ids = [port_b.model.tokenizer.text_to_ids(s) for s in SENTENCES[:n]]
    assert ids == [jax_b.model.tokenizer.text_to_ids(s) for s in SENTENCES[:n]]
    jax_items = [JaxPending(np.asarray(i, np.int32), None, None) for i in ids]
    with jax_eager_draws() as draws:
        jax_b._dispatch(jax_items)
    assert draws[0].shape[0] == (4 if n == 3 else 1)  # rows padded to a power of two
    assert len(draws) == (3 if n == 3 else 2)  # no durations pass for one sentence
    items = [batching._Pending(np.asarray(i, np.int64)) for i in ids]
    with replay_normals(draws):
        port_b._dispatch(items)
    for got, want in zip(items, jax_items, strict=True):
        assert got.done.is_set() and got.error is None
        assert got.wav.shape == want.wav.shape and got.wav.shape[0] % HOP == 0
        np.testing.assert_allclose(got.wav, want.wav, rtol=0, atol=ATOL)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read()


def test_concurrent_requests_through_the_batching_server(model_dir):
    """Three concurrent ``/api/tts`` requests of four sentences through
    ``create_server(max_batch=4)``: each is answered with exactly its own
    sentences' audio from the batcher's dispatches, in order."""
    synth = port_synth(model_dir)
    srv = create_server(synth, port=0, max_batch=4, batch_window_ms=5000)
    assert srv.batcher is not None and srv.batcher.max_batch == 4
    made, sizes = {}, []
    orig = srv.batcher._dispatch

    def recording(batch):
        orig(batch)
        sizes.append(len(batch))
        made.update({tuple(it.ids.tolist()): it.wav for it in batch})

    srv.batcher._dispatch = recording
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    texts = ["Be a voice, not an echo.", "The cats ate. Then they slept.", "Hello there."]
    bodies = {}
    try:
        threads = [threading.Thread(target=lambda t=t: bodies.__setitem__(
            t, _get(f"{base}/api/tts?text={urllib.parse.quote(t)}"))) for t in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not any(th.is_alive() for th in threads)
    finally:
        close_server(srv)
    assert sum(sizes) == 4 and max(sizes) > 1, sizes
    tokenizer = synth.tts_model.tokenizer
    for t in texts:
        code, body = bodies[t]
        assert code == 200 and body[:4] == b"RIFF"
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        parts = []
        for sen in split_into_sentences(t):
            parts += [made[tuple(tokenizer.text_to_ids(sen))], np.zeros(SENTENCE_GAP)]
        want = np.concatenate(parts)
        assert sr == 22050 and pcm.shape == want.shape
        # the server's arithmetic: scaled in float32, truncated to int16
        arr = np.asarray(want, np.float32)
        scaled = (arr * (32767 / max(0.01, float(np.abs(arr).max())))).astype(np.int16)
        np.testing.assert_array_equal(pcm, scaled)


def test_batcher_under_many_threads(model_dir):
    """Twelve callers at once, more than this machine's cores are likely to
    be, with the interpreter switching threads every 10 µs: every call
    returns, each with exactly the audio the worker made for its own
    sentence, and every sentence is dispatched once."""
    batcher = DynamicBatcher(port_synth(model_dir), max_batch=4, window_ms=20)
    made, dispatched = {}, []
    real = batcher._dispatch

    def recording(batch):
        real(batch)
        dispatched.extend(tuple(it.ids.tolist()) for it in batch)
        made.update({tuple(it.ids.tolist()): it.wav for it in batch})

    batcher._dispatch = recording
    texts = [f"Call number {n} is here." for n in range(12)]
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda t=t: results.__setitem__(t, batcher.tts(t)))
                   for t in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    tokenizer = batcher.model.tokenizer
    keys = [tuple(tokenizer.text_to_ids(t)) for t in texts]
    assert sorted(dispatched) == sorted(keys) and len(set(keys)) == 12
    for t, key in zip(texts, keys):
        want = np.concatenate([made[key], np.zeros(SENTENCE_GAP)])
        np.testing.assert_array_equal(np.asarray(results[t], np.float32), want.astype(np.float32))


def test_batcher_refuses_xtts_and_speakers(model_dir, capsys):
    """XTTS (its own ``synthesize``) gets no batcher: the server serves it
    serially and says so. A request naming a speaker or a language to a
    VITS model without speakers or languages is refused, as the
    ``Synthesizer`` refuses it (the server answers 400)."""
    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts

    with torch.device("meta"):
        xtts = Xtts(XttsConfig.from_dict(tiny_xtts_config().to_dict()))
    xtts_synth = types.SimpleNamespace(tts_model=xtts, tts_config=xtts.config,
                                       output_sample_rate=24000)
    with pytest.raises(ValueError, match="generic-inference"):
        DynamicBatcher(xtts_synth)
    srv = create_server(xtts_synth, port=0, max_batch=4)
    srv.server_close()  # never served
    assert srv.batcher is None
    assert "dynamic batching unavailable" in capsys.readouterr().out

    batcher = DynamicBatcher(port_synth(model_dir), max_batch=4)
    try:
        for kw, message in (({"speaker_name": "p225"}, "single-speaker"),
                            ({"language_name": "en"}, "single-language")):
            with pytest.raises(ValueError, match=message):
                batcher.tts("Hello there.", **kw)
    finally:
        batcher.close()


# ---------------------------------------------------------------------------
# F2, F3, F9 and no silent fallback
# ---------------------------------------------------------------------------


def test_packed_decode_refused_for_istft_and_interpolate_z():
    """F2: the JAX ``supports_packed_decode`` checks only for ``istft``, so
    it lets an ``interpolate_z`` model pack; the port's property refuses
    both, and the port's ``inference_packed`` raises on both (the batcher
    serves them through its grouped path)."""
    from tts_tpu.models.vits import Vits as JaxVits
    from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
    from tts_tpu.models.vits import VitsConfig as JaxVitsConfig

    istft = dict(decoder_type="istft")
    interpolated = dict(encoder_sample_rate=11025, interpolate_z=True)
    for kw, jax_says in ((istft, False), (interpolated, True)):
        jax_config = JaxVitsConfig(model_args=JaxVitsArgs(**kw))
        assert JaxVits(jax_config).supports_packed_decode is jax_says
        config = VitsConfig.from_dict(jax_config.to_dict())
        assert supports_packed_decode(config) is False
        with torch.device("meta"):
            model = Vits(config)
        with pytest.raises(ValueError, match="F2"):
            model.inference_packed(None, None, None, None)
    plain = VitsConfig()
    assert supports_packed_decode(plain) and Vits(plain).supports_packed_decode
    same_rate = VitsConfig()
    same_rate.model_args.encoder_sample_rate = same_rate.audio.sample_rate
    assert supports_packed_decode(same_rate)  # no interpolation at one rate


def test_packed_lengths_capped_at_max_inference_len(batchers):
    """F3: with ``max_inference_len`` below the predicted lengths, the
    port's packed segments stop there, as ``Vits.inference`` stops; the
    JAX batcher caps at the frame budget only, so its segments run on to
    their predicted lengths."""
    jax_b, port_b = batchers
    ids = [port_b.model.tokenizer.text_to_ids(s) for s in SENTENCES]
    x, xl = port_b._pad([batching._Pending(np.asarray(i, np.int64)) for i in ids])
    durations = port_b.model.infer_durations(x, xl)[:3].numpy()
    jax_durations = np.asarray(jax_b.model.infer_durations(
        jax_b.synthesizer.tts_params, jnp.asarray(x.numpy()), jnp.asarray(xl.numpy())))[:3]
    cap = 5
    assert durations.min() > cap and jax_durations.min() > cap
    jax_items = [JaxPending(np.asarray(i, np.int32), None, None) for i in ids]
    items = [batching._Pending(np.asarray(i, np.int64)) for i in ids]
    single = [batching._Pending(np.asarray(ids[2], np.int64))]
    jax_b.model.args.max_inference_len = port_b.model.args.max_inference_len = cap
    try:
        with jax.disable_jit(), jax_packing_as_port():
            jax_b._dispatch(jax_items)
        port_b._dispatch(items)
        port_b._dispatch(single)
        synth_wav = port_b.synthesizer.tts(TEXT)
    finally:
        jax_b.model.args.max_inference_len = port_b.model.args.max_inference_len = None
    assert [len(it.wav) for it in items] == [cap * HOP] * 3
    assert [len(it.wav) for it in jax_items] == [int(d) * HOP for d in jax_durations]
    assert len(single[0].wav) == cap * HOP  # one sentence: Vits.inference caps
    assert len(synth_wav) == 3 * (cap * HOP + SENTENCE_GAP)


def quiet_wav(seed=9, quiet_from=1.0, sr=22050):
    """Three seconds of loud noise with a one-second quiet stretch."""
    rs = np.random.RandomState(seed)
    wav = (0.3 * rs.randn(3 * sr)).astype(np.float32)
    start = int(quiet_from * sr)
    wav[start : start + sr] = 1e-4 * rs.randn(sr)
    return wav


def test_file_loaded_synthesizer_trims_as_jax(model_dir, monkeypatch):
    """F9: the JAX ``Synthesizer`` trims a sentence only for a model loaded
    from a checkpoint file whose audio config has ``do_trim_silence`` on. A
    VITS config's audio section (``VitsAudioConfig``) has no such field, so
    as loaded neither package trims. With the flag set on the loaded config,
    as an audio config that has the field carries it, both cut at the first
    0.8 s window whose maximum is below -60 dB (the ``AudioProcessor``'s
    default ``trim_db``), one hop past its start; from a model directory
    neither trims. Both packages' ``synthesis`` return one seeded waveform;
    the packed path trims each piece as the JAX ``trim_silence`` does."""
    import tts_tpu.utils.synthesizer as jax_synthesizer_module
    from tts_tpu.utils.synthesis import trim_silence as jax_trim_silence

    import tts_tpu_torch.utils.synthesizer as port_synthesizer_module

    wav = quiet_wav()
    monkeypatch.setattr(jax_synthesizer_module, "synthesis",
                        lambda *a, **k: {"wav": wav.copy(), "model_outputs": None})
    monkeypatch.setattr(port_synthesizer_module, "synthesis", lambda *a, **k: {"wav": wav.copy()})
    jax_from_file, from_file = jax_synth(model_dir), port_synth(model_dir)
    from_dir = Synthesizer(model_dir=str(model_dir), device="cpu")
    for synth in (jax_from_file, from_file, from_dir):
        assert not hasattr(synth.tts_config.audio, "do_trim_silence")
    as_loaded = np.asarray(from_file.tts(SENTENCES[0]), np.float32)
    np.testing.assert_array_equal(as_loaded, np.asarray(jax_from_file.tts(SENTENCES[0])))
    assert len(as_loaded) == len(wav) + SENTENCE_GAP

    for synth in (jax_from_file, from_file, from_dir):
        synth.tts_config.audio.do_trim_silence = True
    want = np.asarray(jax_from_file.tts(SENTENCES[0]), np.float32)
    assert len(want) == 26460 + SENTENCE_GAP
    np.testing.assert_array_equal(np.asarray(from_file.tts(SENTENCES[0]), np.float32), want)
    assert len(from_dir.tts(SENTENCES[0])) == len(wav) + SENTENCE_GAP

    other = quiet_wav(seed=10, quiet_from=1.5)
    monkeypatch.setattr(port_synthesizer_module, "decode_packed",
                        lambda *a, **k: [wav.copy(), other.copy()])
    got = np.asarray(from_file.tts(" ".join(SENTENCES[:2])), np.float32)
    pieces = [jax_trim_silence(w, jax_from_file.ap) for w in (wav, other)]
    assert [len(p) for p in pieces] == [26460, 39690]
    want = np.concatenate([pieces[0], np.zeros(SENTENCE_GAP), pieces[1], np.zeros(SENTENCE_GAP)])
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_packed_decode_errors_reach_the_caller(model_dir, monkeypatch):
    """No silent fallback: a packed decode that raises raises in
    ``Synthesizer.tts`` and in ``DynamicBatcher.tts``, where the JAX package
    falls back to another path."""
    synth = port_synth(model_dir)

    def boom(*args, **kwargs):
        raise RuntimeError("packed decode failed")

    monkeypatch.setattr(synth.tts_model, "inference_packed", boom)
    with pytest.raises(RuntimeError, match="packed decode failed"):
        synth.tts(TEXT)
    batcher = DynamicBatcher(synth, max_batch=4, window_ms=50)
    try:
        with pytest.raises(RuntimeError, match="packed decode failed"):
            batcher.tts(TEXT)
        assert len(batcher.tts(SENTENCES[0])) > SENTENCE_GAP  # the worker lives on
    finally:
        batcher.close()
    assert not batcher._worker.is_alive()
