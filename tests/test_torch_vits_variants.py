"""The port's iSTFT and encoder-rate VITS variants, and the batcher's grouped
dispatch that serves them, against the JAX package on the CPU.

Tiny models (``test_torch_vits_model.tiny_vits_args``: hidden 32, 2 layers,
N(0, 0.1²) weights carried over by ``vits_from_jax_params``):

* ``istft``: the MB-iSTFT-VITS decoder, 16-point iSTFT at hop 4 after a
  4 x 4 upsampling (1 band), or after 2 x 2 with 4 PQMF bands;
* ``encoder_sample_rate``: the encoders and flow at 11025 Hz under a
  22050 Hz output, hop 16; the latent upsampled twice (``interpolate_z``) or
  the decoder upsampling 4 x 8 itself.

The JAX package's noise is recorded and replayed into the port as in the
other VITS tests, so durations are equal. Tolerances: 1e-5 for modules
short of the waveform (the iSTFT's overlap-add, the PQMF filter, the
latent's resize), 1e-4 for waveforms.

The batcher's durations pass and groups are held against the JAX batcher's
grouped path, with both planning on the port's ``DECODE_GROUP_OVERHEAD``
and on 0; each group then decodes on its planned durations, where the JAX
batcher redraws them (ROADMAP.md F16).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import functools
import json
import threading
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_packed_serving import jax_eager_draws
from test_torch_vits_model import (
    _text_batch,
    port_of,
    record_jax_normals,
    replay_normals,
    tiny_jax_vits,
)

import tts_tpu.utils.synthesis as jax_synthesis
from tts_tpu.models.vits.config import VitsAudioConfig as JaxVitsAudioConfig
from tts_tpu.server.batching import DynamicBatcher as JaxDynamicBatcher
from tts_tpu.server.batching import _Pending as JaxPending
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu.vocoder.models import istft_hifigan as jax_istft
from tts_tpu.vocoder.models.melgan_generator import PQMF as JaxPQMF
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.server import batching
from tts_tpu_torch.server.batching import DynamicBatcher
from tts_tpu_torch.server.server import close_server, create_server
from tts_tpu_torch.utils import synthesis
from tts_tpu_torch.utils.convert import vits_from_jax_params
from tts_tpu_torch.utils.synthesizer import Synthesizer
from tts_tpu_torch.vocoder.layers import PQMF
from tts_tpu_torch.vocoder.models.istft_hifigan import istft_overlap_add

ATOL = 1e-5
WAV_ATOL = 1e-4
ENCODER_RATE_AUDIO = dict(audio=JaxVitsAudioConfig(hop_length=16))
VARIANTS = {
    "istft_1_band": (dict(decoder_type="istft"), {}),
    "istft_4_bands": (dict(decoder_type="istft", upsample_rates_decoder=[2, 2],
                           upsample_kernel_sizes_decoder=[4, 4], istft_subbands_decoder=4), {}),
    "encoder_rate_interpolate_z": (dict(encoder_sample_rate=11025, interpolate_z=True),
                                   ENCODER_RATE_AUDIO),
    "encoder_rate_decoder_upsamples": (dict(encoder_sample_rate=11025, interpolate_z=False,
                                            upsample_rates_decoder=[4, 8],
                                            upsample_kernel_sizes_decoder=[8, 16]),
                                       ENCODER_RATE_AUDIO),
}
HOPS = {"istft_1_band": 64, "istft_4_bands": 64, "encoder_rate_interpolate_z": 32,
        "encoder_rate_decoder_upsamples": 32}
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
SENTENCES = ["Hi.", "Be a voice, not an echo!",
             "The Commission has not been able to find any credible evidence at all.",
             "Prior to November 22, 1963."]


def variant(name, seed=1, **extra):
    kw, config_kw = VARIANTS[name]
    return tiny_jax_vits(seed=seed, config_kw=dict(config_kw, **extra.pop("config_kw", {})),
                         **kw, **extra)


def _close(got, want, atol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (8, 2), (16, 16)])
def test_istft_overlap_add_matches_jax(n_fft, hop):
    rs = np.random.RandomState(n_fft + hop)
    mag = np.exp(rs.randn(2, 21, n_fft // 2 + 1)).astype(np.float32)
    phase = rs.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = jax_istft.istft_overlap_add(jnp.asarray(mag), jnp.asarray(phase), n_fft, hop)
    got = istft_overlap_add(torch.from_numpy(mag), torch.from_numpy(phase), n_fft, hop)
    assert got.shape == (2, 21 * hop)
    _close(got, want, ATOL * 10, "istft")  # magnitudes up to e^3: relative 1e-6
    with pytest.raises(ValueError, match="n_fft % hop"):
        istft_overlap_add(torch.from_numpy(mag), torch.from_numpy(phase), n_fft, 3)


@pytest.mark.parametrize("bands", [2, 4])
def test_pqmf_synthesis_matches_jax(bands):
    x = np.random.RandomState(bands).randn(2, 40, bands).astype(np.float32)
    want = JaxPQMF(N=bands).synthesis(jnp.asarray(x))
    got = PQMF(N=bands).synthesis(torch.from_numpy(x))
    assert got.shape == (2, 40 * bands, 1)
    _close(got, want, ATOL, "pqmf synthesis")


@pytest.mark.parametrize("name", ["istft_1_band", "istft_4_bands"])
def test_istft_decoder_carries_over_and_matches_jax(name):
    """``vits_from_jax_params`` carries the iSTFT decoder strictly (every key
    of the port's module, the upsampling kernels flipped back); the decoder
    alone, with and without a speaker vector, matches the JAX one."""
    jm, params = variant(name, use_speaker_embedding=True, num_speakers=3)
    port = port_of(jm, params)
    assert set(vits_from_jax_params(params)) == set(port.module.state_dict())
    assert any(k.startswith("waveform_decoder.conv_post.bias") for k in port.module.state_dict())
    z = np.random.RandomState(6).randn(2, 24, 32).astype(np.float32)
    g = np.random.RandomState(7).randn(2, 256).astype(np.float32)
    for cond in (None, g):
        want = jm.module.apply(params, jnp.asarray(z), None if cond is None else jnp.asarray(cond),
                               method=lambda m, z, g: m.waveform_decoder(z, g=g))
        got = port.module.waveform_decoder(torch.from_numpy(z),
                                           None if cond is None else torch.from_numpy(cond))
        assert got.shape == (2, 24 * 64, 1)
        _close(got, want, WAV_ATOL, f"decoder, g={'on' if cond is not None else 'off'}")


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_z_is_jax_image_resize_edges_included(factor):
    """``F.interpolate(mode="linear", align_corners=False)`` is the JAX
    package's half-pixel ``jax.image.resize``, the first and last frames
    included (both clamp there to the edge frame)."""
    jm, params = variant("encoder_rate_interpolate_z")
    port = port_of(jm, params)
    port.module.interpolate_factor = float(factor)
    z = np.random.RandomState(factor).randn(2, 17, 32).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(z), (2, 17 * factor, 32), method="linear"))
    got = port.module._upsample_z(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape
    _close(got[:, :factor], want[:, :factor], 1e-6, "leading edge")
    _close(got[:, -factor:], want[:, -factor:], 1e-6, "trailing edge")
    _close(got, want, 1e-6, "resize")
    np.testing.assert_allclose(got[:, 0], z[:, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, -1], z[:, -1], atol=1e-6)
    port.module.args.interpolate_z = False
    assert port.module._upsample_z(torch.from_numpy(z)).shape == (2, 17, 32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_inference_matches_jax(name):
    """``Vits.inference`` of each variant against the JAX ``inference`` on
    its draws: ``y_lengths`` and durations equal, the waveform within 1e-4,
    ``hop_length`` samples per latent frame."""
    jm, params = variant(name)
    port = port_of(jm, params)
    assert port.hop_length == HOPS[name]
    x, xl = _text_batch(seed=3)
    with record_jax_normals() as draws:
        want = jm.inference(params, jnp.asarray(x), jnp.asarray(xl), max_frames=96)
    with replay_normals(draws):
        got = port.inference(torch.from_numpy(x).long(), torch.from_numpy(xl), max_frames=96)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    assert got["model_outputs"].shape == (2, 96 * HOPS[name], 1)
    _close(got["model_outputs"], want["model_outputs"], WAV_ATOL, "waveform")


@pytest.mark.parametrize("audio,args,match", [
    (dict(sample_rate=22050), dict(encoder_sample_rate=16000), "integer multiple"),
    (dict(hop_length=256), dict(encoder_sample_rate=11025, interpolate_z=False), "upsampling"),
    (dict(hop_length=256), dict(encoder_sample_rate=11025, decoder_type="istft"), "upsampling"),
], ids=["rates", "decoder_upsampling", "istft_upsampling"])
def test_interpolate_factor_checks_match_jax(audio, args, match):
    """The JAX package's two checks of an encoder rate, raised by both."""
    from tts_tpu.models.vits import Vits as JaxVits
    from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
    from tts_tpu.models.vits import VitsConfig as JaxVitsConfig

    jax_config = JaxVitsConfig(model_args=JaxVitsArgs(**args), audio=JaxVitsAudioConfig(**audio))
    with pytest.raises(ValueError, match=match):
        JaxVits(jax_config)
    with pytest.raises(ValueError, match=match), torch.device("meta"):
        Vits(VitsConfig.from_dict(jax_config.to_dict()))


def test_unknown_decoder_type_raises():
    """The JAX package builds HiFiGAN for any name but ``istft``; the port
    refuses a name it does not know."""
    config = VitsConfig()
    config.model_args.decoder_type = "melgan"
    with pytest.raises(ValueError, match="decoder_type"):
        Vits(config)


# ---------------------------------------------------------------------------
# the grouped plan and the batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_plan_decode_groups_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(1, 9))
    lengths = rs.randint(1, 900, n)
    for overhead in (0, 256, synthesis.DECODE_GROUP_OVERHEAD, 20000):
        for max_groups in (1, 2, 3):
            kw = dict(multiple=32, cap=int(rs.choice([512, 1024, 4096])), overhead=overhead,
                      max_groups=max_groups)
            got = synthesis.plan_decode_groups(lengths, **kw)
            assert got == jax_synthesis.plan_decode_groups(lengths, **kw), kw
            assert sorted(i for idx, _ in got for i in idx) == list(range(n))


def test_the_overhead_is_the_cards_reading():
    """The constant carries the H100 fit, not the JAX package's TPU figure."""
    import inspect

    assert synthesis.DECODE_GROUP_OVERHEAD != 2048
    assert "H100" in synthesis.DECODE_GROUP_FIT
    assert inspect.signature(jax_synthesis.plan_decode_groups).parameters[
        "overhead"].default == 2048


@pytest.fixture(scope="module", params=["istft_1_band", "encoder_rate_interpolate_z"])
def model_dir(request, tmp_path_factory):
    """A variant with a grapheme vocabulary as the JAX package's
    ``model.msgpack`` and the port's ``model_torch.pt``."""
    from tts_tpu.utils.io import save_checkpoint

    d = tmp_path_factory.mktemp(request.param)
    jm, params = variant(request.param, seed=4, config_kw=RECIPE, num_chars=100)
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), d / "model_torch.pt")
    return d


def jax_synth(model_dir, **kwargs):
    return JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                          tts_config_path=str(model_dir / "config.json"), **kwargs)


def port_synth(model_dir):
    return Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                       tts_config_path=str(model_dir / "config.json"), device="cpu")


def test_multi_sentence_requests_take_the_serial_loop_as_in_jax(model_dir):
    """A variant's multi-sentence request decodes sentence by sentence, as
    the JAX ``Synthesizer`` decodes it (its default path), sample for
    sample within 1e-4."""
    text = " ".join(SENTENCES[1:])
    with jax_eager_draws() as draws:
        want = np.asarray(jax_synth(model_dir).tts(text), np.float32)
    synth = port_synth(model_dir)
    assert not synth.tts_model.supports_packed_decode
    with replay_normals(draws):
        got = np.asarray(synth.tts(text), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


@contextlib.contextmanager
def overhead(value):
    """Both batchers plan their groups with ``overhead=value``."""
    jax_orig, port_orig = jax_synthesis.plan_decode_groups, batching.plan_decode_groups
    jax_synthesis.plan_decode_groups = functools.partial(jax_orig, overhead=value)
    batching.plan_decode_groups = functools.partial(port_orig, overhead=value)
    try:
        yield
    finally:
        jax_synthesis.plan_decode_groups = jax_orig
        batching.plan_decode_groups = port_orig


@contextlib.contextmanager
def first_draw_replayed(draw):
    """The port's first noise draw returns ``draw``; later draws come from
    their generators."""
    from tts_tpu_torch.models.vits import modules

    orig, calls = modules.normal, []

    def replay(shape, generator):
        calls.append(tuple(shape))
        if len(calls) > 1:
            return orig(shape, generator)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(draw).to(generator.device)

    modules.normal = replay
    try:
        yield calls
    finally:
        modules.normal = orig


@contextlib.contextmanager
def recorded(obj, name, record):
    """``obj.name`` wrapped so that each call's result is passed to
    ``record`` first."""
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        record(out)
        return out

    setattr(obj, name, wrapper)
    try:
        yield
    finally:
        setattr(obj, name, real)


@pytest.mark.parametrize("cost", ["card", "zero"])
def test_f16_grouped_dispatch_decodes_planned_durations(model_dir, cost, monkeypatch):
    """F16. Four sentences of mixed lengths through each batcher's
    ``_dispatch``: one durations pass over the four plans the groups (two
    where a dispatch costs nothing), each group decoded at its bucket.

    The JAX batcher draws the durations again in each group's decode, so a
    sentence comes out at another length than the one it was planned at
    (and one drawn longer than its bucket is cut there). The port decodes
    each group on the planned durations: every sentence's ``y_lengths`` is
    its planned length, and its audio is that group's ``inference`` on the
    planned durations from the same generator, sample for sample. The
    text encoder and the durations pass stay held to the JAX package's:
    on the JAX draw, the same predicted lengths and the same groups. F2:
    the JAX package lets an ``interpolate_z`` model take its packed path,
    so its grouped path runs with that model's packed decode refused."""
    from tts_tpu.models.vits import Vits as JaxVits

    monkeypatch.setattr(JaxVits, "supports_packed_decode", False)
    value = synthesis.DECODE_GROUP_OVERHEAD if cost == "card" else 0
    jax_b = JaxDynamicBatcher(jax_synth(model_dir, use_griffin_lim=False), max_batch=4)
    port_b = DynamicBatcher(port_synth(model_dir), max_batch=4)
    port = port_b.model
    jax_plans, jax_lengths, plans, lengths = [], [], [], []

    def jitted_inference(real):
        def get(model):
            infer = real(model)

            def recording(*args, **kwargs):
                out = infer(*args, **kwargs)
                jax_lengths.append(np.asarray(out["y_lengths"]))
                return out
            return recording
        return get

    try:
        ids = [port.tokenizer.text_to_ids(s) for s in SENTENCES]
        jax_items = [JaxPending(np.asarray(i, np.int32), None, None) for i in ids]
        monkeypatch.setattr(jax_synthesis, "get_jitted_inference",
                            jitted_inference(jax_synthesis.get_jitted_inference))
        with overhead(value), jax_eager_draws() as draws:
            planner = jax_synthesis.plan_decode_groups
            jax_synthesis.plan_decode_groups = lambda y, *a, **k: (
                jax_plans.append((np.asarray(y), planner(y, *a, **k))) or jax_plans[-1][1])
            try:
                jax_b._dispatch(jax_items)
            finally:
                jax_synthesis.plan_decode_groups = planner
        items = [batching._Pending(np.asarray(i, np.int64)) for i in ids]
        with overhead(value), first_draw_replayed(draws[0]) as calls:
            planner = batching.plan_decode_groups
            batching.plan_decode_groups = lambda y, *a, **k: (
                plans.append((np.asarray(y), planner(y, *a, **k))) or plans[-1][1])
            try:
                with recorded(port, "inference",
                              lambda out: lengths.append(out["y_lengths"].numpy())):
                    port_b._dispatch(items)
            finally:
                batching.plan_decode_groups = planner
        with first_draw_replayed(draws[0]):
            x, x_lengths = port_b._pad(items)
            w_ceil = port.durations(x, x_lengths)
    finally:
        jax_b.close()
        port_b.close()

    (jax_y, jax_groups), = jax_plans
    (y_pred, groups), = plans
    assert len(draws) == 1 + 2 * len(jax_groups)  # durations pass, then each group redraws
    assert len(calls) == 1 + len(groups)  # durations pass, then each group's latent only
    np.testing.assert_array_equal(y_pred, jax_y)
    assert [(list(i), f) for i, f in groups] == [(list(i), f) for i, f in jax_groups]
    if cost == "zero":
        assert len(groups) == 2
    planned = {i: min(int(y_pred[i]), frames) for idx, frames in groups for i in idx}
    jax_decoded = {i: int(n) for (idx, _), ls in zip(jax_groups, jax_lengths)
                   for i, n in zip(idx, ls)}
    decoded = {i: int(n) for (idx, _), ls in zip(groups, lengths) for i, n in zip(idx, ls)}
    assert any(jax_decoded[i] != planned[i] for i in planned), (jax_decoded, planned)
    assert decoded == planned
    hop = port.hop_length
    for idx, frames in groups:
        group = [items[i] for i in idx]
        gx, gx_lengths = port_b._pad(group)
        durations = torch.zeros(gx.shape[0], gx.shape[1], 1)
        durations[: len(idx)] = w_ceil[idx, : gx.shape[1]]
        want = port.inference(gx, gx_lengths, max_frames=frames, durations=durations)
        wav = want["model_outputs"][..., 0].numpy()
        for row, it in enumerate(group):
            assert it.done.is_set() and it.error is None
            assert len(it.wav) == planned[idx[row]] * hop
            np.testing.assert_array_equal(it.wav, wav[row, : len(it.wav)])


def test_grouped_lengths_capped_at_max_inference_len(tmp_path):
    """F3: each group decodes at most ``max_inference_len`` frames, and each
    sentence's audio is cut at its own length within that."""
    jm, params = variant("istft_1_band", seed=4, config_kw=RECIPE, num_chars=100,
                         max_inference_len=40)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), tmp_path / "model_torch.pt")
    batcher = DynamicBatcher(port_synth(tmp_path), max_batch=4)
    try:
        ids = [batcher.model.tokenizer.text_to_ids(s) for s in SENTENCES]
        items = [batching._Pending(np.asarray(i, np.int64)) for i in ids]
        with overhead(0):
            batcher._dispatch(items)
    finally:
        batcher.close()
    lengths = [len(it.wav) // 64 for it in items]
    assert max(lengths) == 40 and all(len(it.wav) % 64 == 0 for it in items)


def test_grouped_dispatch_errors_reach_every_caller(model_dir):
    port_b = DynamicBatcher(port_synth(model_dir), max_batch=4, window_ms=200)

    def broken(*args, **kwargs):
        raise RuntimeError("decode failed")

    port_b.model.inference = broken
    errors = []

    def call(text):
        try:
            port_b.tts(text)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=call, args=(s,)) for s in SENTENCES[:3]]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        port_b.close()
    assert errors == ["decode failed"] * 3


def test_server_batches_a_variant(model_dir):
    """``--max_batch 4`` serves a variant through the batcher (it no longer
    refuses models without a packed decode): concurrent ``/api/tts``
    requests answer 200 with audio."""
    server = create_server(port_synth(model_dir), 0, max_batch=4)
    assert server.batcher is not None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = {}

    def get(i, text):
        url = f"http://127.0.0.1:{server.server_address[1]}/api/tts?text={urllib.parse.quote(text)}"
        with urllib.request.urlopen(url, timeout=120) as r:
            results[i] = (r.status, len(r.read()))

    threads = [threading.Thread(target=get, args=(i, s)) for i, s in enumerate(SENTENCES)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        close_server(server)
        thread.join(timeout=60)
    assert sorted(results) == [0, 1, 2, 3]
    assert all(status == 200 and size > 44 for status, size in results.values())
