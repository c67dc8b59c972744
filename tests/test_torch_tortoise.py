"""tts_tpu_torch Tortoise against the JAX package's (``tts_tpu.models.tortoise``)
on the CPU, module by module, at a small size (2 AR layers 32 wide with the
real 255-token text vocabulary and 100 mel codes; a 2-layer diffusion
decoder 64 wide over the 100-channel univnet mel, so that a norm group holds
4 channels (at 32 wide it holds 2, and the conditioning-free path's
time-constant input makes their norm ill-conditioned); a 2-layer CLVP 32
wide; the bundled UnivNet 8 wide at hop 256).

Both packages load the same weights: flax params drawn at unit gain
(``drawn``: kernels N(0, 1/fan_in), scales 1 + N(0, 0.1²), other leaves
N(0, 0.1²), embeddings N(0, 1); the vocoder's every leaf N(0, 0.05²): it
takes denormalised log-mels near -5, and at unit gain its kernel predictor
saturates the output, where 1e-7 differences become 1e-2), carried into the
port by
``tortoise_from_jax_params``. The JAX modules run under ``jax.jit``.

Tolerances (fp32): logits, latents and CLVP scores within 1e-5 of their
peak; mels and waveforms within 1e-4 of their peak. The AR decode is held
token for token with greedy decoding (``top_p`` 1e-6 keeps the top token);
the diffusion's initial noise, the vocoder's noise and the random-voice
draws are the JAX package's, handed to the port (``noise=``, or
``tts_tpu_torch.models.tortoise.model.normal`` replaying them). F45 (the
exact cut at the end of speech) and F47 (CLVP and a code past its
vocabulary) are named here.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_glow_tts import drawn_params

from tts_tpu.models.tortoise import audio as jax_audio
from tts_tpu.models.tortoise import model as jax_model
from tts_tpu.models.tortoise.config import TortoiseArgs as JaxArgs
from tts_tpu.models.tortoise.config import TortoiseConfig as JaxConfig
from tts_tpu.models.tortoise.layers import CLVP as JaxCLVP
from tts_tpu.models.tortoise.layers import DiffusionTts as JaxDiffusion
from tts_tpu.models.tortoise.tokenizer import VoiceBpeTokenizer as JaxTokenizer
from tts_tpu.utils import convert as jax_convert
from tts_tpu_torch.models.tortoise import audio
from tts_tpu_torch.models.tortoise import model as tortoise
from tts_tpu_torch.models.tortoise.config import TortoiseArgs, TortoiseConfig
from tts_tpu_torch.models.tortoise.layers import CLVP
from tts_tpu_torch.models.tortoise.tokenizer import VoiceBpeTokenizer
from tts_tpu_torch.utils import convert

TINY = dict(ar_layers=2, ar_model_dim=32, ar_heads=2, ar_number_mel_codes=100,
            ar_start_mel_token=98, ar_stop_mel_token=99, diff_model_channels=64,
            diff_num_layers=2, diff_in_latent_channels=32, diff_num_heads=2,
            voc_noise_dim=8, voc_channel_size=8, diffusion_iterations=30,
            num_autoregressive_samples=2, top_p=1e-6)
CLVP_KW = dict(dim_text=32, dim_speech=32, dim_latent=32, num_text_tokens=256,
               text_enc_depth=2, text_heads=2, num_speech_tokens=98, speech_enc_depth=2,
               speech_heads=2)
TEXTS = ["Hello world.", "The quick brown fox jumps over the lazy dog!",
         "I owe you $13.50 — pay up, mister; it's overdue.",
         "Dr. Smith lives on St. George's Rd.", "He said: \"twenty-two llamas?!\"",
         "1,234,567 and 3rd and 2nd and 1st"]


def peak_close(got, want, rel, what=""):
    """``got`` within ``rel`` of ``want``'s peak."""
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * peak, f"{what}: max abs err {err:.3g} > {rel} x peak {peak:.3g}"


def drawn(init_fn, *args, seed=0, **kwargs):
    """Numpy params of ``init_fn``'s structure at unit gain: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1²), embeddings N(0, 1), every other
    leaf N(0, 0.1²)."""
    shapes = jax.eval_shape(init_fn, *args, **kwargs)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        draw = rs.standard_normal(leaf.shape)
        if name == "kernel":
            draw = draw / math.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "g"):
            draw = 1 + 0.1 * draw
        elif name != "embedding":
            draw = 0.1 * draw
        return draw.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_tiny(**kw):
    """A small JAX ``Tortoise`` with drawn weights for the AR model, the
    diffusion decoder, a small CLVP and the vocoder."""
    cfg = JaxConfig()
    cfg.model_args = JaxArgs(**(TINY | kw))
    jm = jax_model.Tortoise(cfg)
    ar, diff = drawn(lambda: jm.init_params(jax.random.PRNGKey(0)), seed=1)
    jm.ar_params, jm.diff_params = ar, diff
    jm.clvp = JaxCLVP(**CLVP_KW)
    jm.clvp_params = drawn(jm.clvp.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                           jnp.zeros((1, 6), jnp.int32), seed=2)
    jm.vocoder_params = drawn_params(jm.vocoder.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4, 100)), jnp.zeros((1, 4, 8)),
                                     seed=3, scale=0.05)
    return jm


def port_of(jm, clvp=True, vocoder=True):
    """The port's ``Tortoise`` on ``jm``'s weights (CPU)."""
    cfg = TortoiseConfig.from_dict(jm.config.to_dict())
    pm = tortoise.Tortoise(cfg)
    states = convert.tortoise_from_jax_params(
        jm.ar_params, jm.diff_params, jm.clvp_params if clvp else None,
        jm.vocoder_params if vocoder else None)
    if clvp:
        pm.clvp = CLVP(**CLVP_KW)
    if vocoder:
        pm.vocoder = pm.build_vocoder()
    for name, state in states.items():
        getattr(pm, name).load_state_dict(state, strict=True)
    return pm.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def pair():
    jm = jax_tiny()
    return jm, port_of(jm)


def jitted(module, method=None):
    return jax.jit(functools.partial(module.apply, method=method))


def ar_inputs(seed=0, B=2):
    rs = np.random.RandomState(seed)
    cond = rs.randn(B, 40, 80).astype(np.float32)
    text = rs.randint(1, 250, (B, 9))
    codes = rs.randint(0, 98, (B, 14))
    return cond, text, codes


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------


def test_tokenizer_matches_jax():
    """The port's BPE (its own copy of the vocabulary, its own cleaners)
    against the JAX package's, encode and decode."""
    ours, theirs = VoiceBpeTokenizer(), JaxTokenizer()
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text) and len(ids) > 2, text
        assert ours.decode(ids) == theirs.decode(ids), text


def test_host_helpers_match_jax():
    """``fix_autoregressive_codes`` (stops recoded, the DVAE suffix) and
    ``trim_index_at_calm`` as in the JAX package."""
    rs = np.random.RandomState(0)
    codes = rs.randint(0, 100, (4, 40))
    codes[1, 17] = 99
    codes[2, 30:] = 99
    codes[3, 5:20] = 83
    for stop in (99, 50):
        np.testing.assert_array_equal(tortoise.fix_autoregressive_codes(codes, stop),
                                      jax_model.fix_autoregressive_codes(codes, stop))
    for row in tortoise.fix_autoregressive_codes(codes, 99):
        assert tortoise.trim_index_at_calm(row) == jax_model.trim_index_at_calm(row)
    assert tortoise.trim_index_at_calm(codes[3]) == 13


def test_audio_front_ends_match_jax(tmp_path):
    """The tacotron-domain mel (with ``mel_norms``), the univnet mel,
    ``format_conditioning`` and the reference clip loaded at 22.05 and 24
    kHz by the port's loader and resampler, against the JAX package's."""
    import scipy.io.wavfile

    from tts_tpu.audio.numpy_transforms import load_wav as jax_load_wav
    from tts_tpu_torch.audio.numpy_transforms import load_wav

    wav = (np.random.RandomState(0).randn(2, 4096) * 0.3).astype(np.float32)
    norms = np.linspace(0.5, 2.0, 80).astype(np.float32)
    peak_close(audio.tacotron_mel(torch.from_numpy(wav), torch.from_numpy(norms)),
               jax_audio.tacotron_mel(jnp.asarray(wav), norms), 1e-5, "tacotron mel")
    peak_close(audio.wav_to_univnet_mel(torch.from_numpy(wav)),
               jax_audio.wav_to_univnet_mel(jnp.asarray(wav)), 1e-5, "univnet mel")
    peak_close(audio.format_conditioning(wav[0], torch.from_numpy(norms), cond_length=6000),
               jax_audio.format_conditioning(wav[0], norms, cond_length=6000), 1e-5,
               "conditioning")
    clip = (np.sin(np.arange(33075) * 0.05) * 16000).astype(np.int16)
    path = str(tmp_path / "clip.wav")
    scipy.io.wavfile.write(path, 22050, clip)
    for sr in (22050, 24000):
        got = load_wav(filename=path, sample_rate=sr, resample=True)
        want = jax_load_wav(filename=path, sample_rate=sr, resample=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(load_wav(filename=path, sample_rate=24000, resample=True)) == 36000


def test_jax_params_carry_over_strictly(pair):
    """Every leaf of the JAX params lands on a parameter of the port, and
    every parameter is covered (``load_state_dict`` is strict)."""
    jm, pm = pair
    states = convert.tortoise_from_jax_params(jm.ar_params, jm.diff_params, jm.clvp_params,
                                              jm.vocoder_params)
    for name, state in states.items():
        assert set(state) == set(getattr(pm, name).state_dict()), name


# ---------------------------------------------------------------------------
# UnifiedVoice
# ---------------------------------------------------------------------------


def test_conditioning_matches_jax(pair):
    """The AR model's conditioning latent (the first position of its
    attention encoder) and the diffusion decoder's (the contextual
    embedder's mean), within 1e-5 of their peaks."""
    jm, pm = pair
    cond, _, _ = ar_inputs()
    want = jitted(jm.autoregressive, jax_model.UnifiedVoice.get_conditioning)(
        jm.ar_params, jnp.asarray(cond))
    got = pm.autoregressive.get_conditioning(torch.from_numpy(cond))
    assert got.shape == (2, 1, 32)
    peak_close(got, want, 1e-5, "AR conditioning")
    mel = np.random.RandomState(1).randn(2, 50, 100).astype(np.float32)
    want = jitted(jm.diffusion, JaxDiffusion.get_conditioning)(jm.diff_params, jnp.asarray(mel))
    got = pm.diffusion.get_conditioning(torch.from_numpy(mel))
    assert got.shape == (2, 128)
    peak_close(got, want, 1e-5, "diffusion conditioning")


def test_teacher_forced_forward_matches_jax(pair):
    """Text and mel logits and the mel latents of the teacher-forced pass."""
    jm, pm = pair
    cond, text, codes = ar_inputs()
    cl = np.array(jitted(jm.autoregressive, jax_model.UnifiedVoice.get_conditioning)(
        jm.ar_params, jnp.asarray(cond)))
    want = jitted(jm.autoregressive)(jm.ar_params, jnp.asarray(cl), jnp.asarray(text),
                                     jnp.asarray(codes))
    with torch.no_grad():
        got = pm.autoregressive(torch.from_numpy(cl), torch.from_numpy(text),
                                torch.from_numpy(codes))
    for g, w, what in zip(got, want, ("text logits", "mel logits", "mel latents")):
        peak_close(g, w, 1e-5, what)


def greedy_jax(jm, cl, text, steps, key=3):
    fn = jax.jit(lambda p, c, t, r: jm.autoregressive.apply(
        p, c, t, r, max_new_tokens=steps, temperature=0.8, top_p=1e-6,
        repetition_penalty=2.0, method=jax_model.UnifiedVoice.generate))
    return fn(jm.ar_params, jnp.asarray(cl), jnp.asarray(text), jax.random.PRNGKey(key))


def test_greedy_generate_token_identical(pair):
    """Greedy decoding (``top_p`` 1e-6) of two rows: the codes, the lengths
    and the latent that predicted each code, on the port's KV cache and
    decode-attention path; one decode step a token."""
    jm, pm = pair
    cond, text, _ = ar_inputs(seed=4)
    cl = np.array(jitted(jm.autoregressive, jax_model.UnifiedVoice.get_conditioning)(
        jm.ar_params, jnp.asarray(cond)))
    want = greedy_jax(jm, cl, text, 20)
    steps = pm.autoregressive.decode_steps
    got = pm.autoregressive.generate(torch.from_numpy(cl), torch.from_numpy(text), None,
                                     max_new_tokens=20, temperature=0.8, top_p=1e-6,
                                     repetition_penalty=2.0)
    assert pm.autoregressive.decode_steps == steps + 20
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    peak_close(got["latents"], want["latents"], 1e-5, "latents")
    assert len(set(np.asarray(want["codes"])[0].tolist())) > 3  # not one repeated token


def test_generate_stops_early_once_every_row_is_done(pair):
    """With the stop token's logit raised, every row stops at its first
    step: the port's loop leaves at its first read of the done flags (8
    steps) and fills the codes with stop tokens, equal to the JAX scan's
    whole run."""
    jm, pm = pair
    params = jax.tree_util.tree_map(np.array, jm.ar_params)
    params["params"]["mel_head"]["bias"][99] = 100.0
    cond, text, _ = ar_inputs(seed=4)
    cl = np.array(jitted(jm.autoregressive, jax_model.UnifiedVoice.get_conditioning)(
        jm.ar_params, jnp.asarray(cond)))
    fn = jax.jit(lambda p, c, t, r: jm.autoregressive.apply(
        p, c, t, r, max_new_tokens=30, top_p=1e-6, method=jax_model.UnifiedVoice.generate))
    want = fn(params, jnp.asarray(cl), jnp.asarray(text), jax.random.PRNGKey(0))
    bias = pm.autoregressive.mel_head.bias
    saved = bias[99].item()
    bias[99] = 100.0
    try:
        steps = pm.autoregressive.decode_steps
        got = pm.autoregressive.generate(torch.from_numpy(cl), torch.from_numpy(text), None,
                                         max_new_tokens=30, top_p=1e-6)
    finally:
        bias[99] = saved
    assert pm.autoregressive.decode_steps == steps + tortoise.DONE_CHECK_EVERY
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert (got["codes"].numpy() == 99).all() and not got["lengths"].any()
    peak_close(got["latents"], np.asarray(want["latents"])[:, : tortoise.DONE_CHECK_EVERY],
               1e-5, "latents of the steps run")


# ---------------------------------------------------------------------------
# the diffusion decoder and its samplers
# ---------------------------------------------------------------------------


def test_diffusion_decoder_matches_jax(pair):
    """``timestep_independent`` (latents stretched to the output length),
    then the denoiser, conditioned and conditioning-free."""
    jm, pm = pair
    rs = np.random.RandomState(5)
    lat = rs.randn(2, 12, 32).astype(np.float32)
    cond = rs.randn(2, 128).astype(np.float32)
    x = rs.randn(2, 26, 100).astype(np.float32)
    t = np.asarray([13, 3077])
    emb = jax.jit(functools.partial(jm.diffusion.apply, method=JaxDiffusion.timestep_independent),
                  static_argnums=3)(jm.diff_params, jnp.asarray(lat), jnp.asarray(cond), 26)
    with torch.no_grad():
        got_emb = pm.diffusion.timestep_independent(torch.from_numpy(lat),
                                                    torch.from_numpy(cond), 26)
        peak_close(got_emb, emb, 1e-5, "embeddings")
        for free in (False, True):
            want = jax.jit(functools.partial(jm.diffusion.apply, conditioning_free=free))(
                jm.diff_params, jnp.asarray(x), jnp.asarray(t), precomputed_embeddings=emb)
            got = pm.diffusion(torch.from_numpy(x), torch.from_numpy(t),
                               precomputed_embeddings=torch.from_numpy(np.array(emb)),
                               conditioning_free=free)
            peak_close(got, want, 1e-5, f"denoiser (conditioning_free={free})")


def jax_initial_noise(key, shape):
    r0, _ = jax.random.split(key)
    return np.array(jax.random.normal(r0, shape))


@pytest.mark.parametrize("sampler,steps", [("ddim", 30), ("dpm++2m", 10)])
def test_samplers_match_jax_on_its_noise(pair, sampler, steps):
    """DDIM and DPM-Solver++(2M) at their default step counts with
    classifier-free guidance, from the JAX draw of the initial noise: the
    denormalised mel within 1e-4 of its peak. The first step divides the
    denoiser's output by sqrt(abar[3999]) ~ 6.7e-3, which turns its fp32
    rounding (1e-5 of its peak, above) into up to ~2e-4 of the normalised
    mel where few steps follow (1 to 10 DDIM steps), so fewer steps are not
    held to this bound. The step times are the JAX package's float32
    schedule's (for 4 steps 3999, 2665, 1332, 0, where a float64 linspace
    gives 2666 and 1333)."""
    jm, pm = pair
    rs = np.random.RandomState(6)
    emb = rs.randn(1, 20, 64).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(steps=steps, in_channels=100, temperature=0.9, cond_free=True, cond_free_k=2.0)
    want = jax.jit(lambda p, e, r: jax_model.SAMPLERS[sampler](jm.diffusion, p, e, 20, r, **kw))(
        jm.diff_params, jnp.asarray(emb), key)
    got = tortoise.SAMPLERS[sampler](pm.diffusion, torch.from_numpy(emb), 20, None,
                                     noise=torch.from_numpy(jax_initial_noise(key, (1, 20, 100))),
                                     **kw)
    peak_close(audio.denormalize_tacotron_mel(got),
               jax_audio.denormalize_tacotron_mel(want), 1e-4, f"{sampler} {steps} steps")
    assert tortoise._schedule(4000, 4)[1] == [3999, 2665, 1332, 0]
    want_ts = np.asarray(jnp.linspace(3999, 0, steps).astype(jnp.int32)).tolist()
    assert tortoise._schedule(4000, steps)[1] == want_ts


# ---------------------------------------------------------------------------
# CLVP, the vocoder, the random voice
# ---------------------------------------------------------------------------


def test_clvp_scores_match_jax(pair):
    jm, pm = pair
    rs = np.random.RandomState(7)
    text = rs.randint(0, 256, (1, 11))
    codes = rs.randint(0, 98, (3, 17))
    want = jm.rerank(jnp.asarray(text[0]), jnp.asarray(codes))
    got = pm.rerank(torch.from_numpy(text[0]), torch.from_numpy(codes))
    peak_close(got, want, 1e-5, "CLVP scores")


def test_f47_clvp_never_picks_a_code_past_its_vocabulary(pair):
    """F47. A candidate holding the AR start token (past CLVP's 98 speech
    tokens here, as 8192 is past the real CLVP's 8192) has a NaN embedding
    in the JAX package, so its score is NaN and ``np.argmax`` picks it. The
    port scores it ``-inf`` and keeps the best of the others, whose scores
    are the JAX package's."""
    jm, pm = pair
    rs = np.random.RandomState(8)
    text = rs.randint(0, 256, (11,))
    codes = rs.randint(0, 98, (3, 17))
    codes[0, 5] = 98
    want = np.asarray(jm.rerank(jnp.asarray(text), jnp.asarray(codes)))
    got = pm.rerank(torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    assert np.isnan(want[0]) and int(np.argmax(want)) == 0
    assert got[0] == -np.inf and int(np.argmax(got)) == 1 + int(np.argmax(want[1:]))
    peak_close(got[1:], want[1:], 1e-5, "the other scores")


def test_vocode_matches_jax(pair):
    """The bundled UnivNet through ``vocode``: 10 silence frames appended,
    the JAX noise, the waveform cut at ``hop * T`` and clipped."""
    jm, pm = pair
    mel = (np.random.RandomState(9).randn(1, 6, 100) - 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jm.vocode(jnp.asarray(mel), key)
    noise = np.asarray(jax.random.normal(key, (1, 16, 8)))
    with replayed([noise]):
        got = pm.vocode(torch.from_numpy(mel), torch.Generator())
    assert got.shape == (1, 6 * 256)
    peak_close(got, want, 1e-4, "vocoded waveform")


@contextlib.contextmanager
def replayed(draws):
    """The port's Tortoise draws return ``draws`` in order, shapes checked;
    all must be used."""
    queue = [np.array(d, np.float32) for d in draws]
    orig = tortoise.normal

    def replay(shape, generator):
        value = queue.pop(0)
        assert tuple(value.shape) == tuple(shape), (value.shape, shape)
        return torch.from_numpy(value)

    tortoise.normal = replay
    try:
        yield
    finally:
        tortoise.normal = orig
    assert not queue, f"{len(queue)} draws left unused"


def rlg_state(channels, seed):
    """A random latent generator's state (reference ``RandomLatentConverter``:
    five EqualLinear layers and a Linear)."""
    rs = np.random.RandomState(seed)
    state = {}
    for i in range(6):
        state[f"layers.{i}.weight"] = rs.randn(channels, channels).astype(np.float32) * (
            1.0 if i < 5 else 1 / math.sqrt(channels))
        state[f"layers.{i}.bias"] = rs.randn(channels).astype(np.float32) * 0.1
    return state


def test_random_voice_matches_jax(pair):
    """The random-voice latents through the random latent generators, and
    the scaled draws without them, on the JAX draws."""
    jm, pm = pair
    key = jax.random.PRNGKey(5)
    r1, r2 = jax.random.split(key)
    want = jm.get_random_conditioning_latents(key)
    with replayed([jax.random.normal(r1, (1, 1, 32)), jax.random.normal(r2, (1, 128))]):
        got = pm.get_random_conditioning_latents(torch.Generator())
    for g, w in zip(got, want):
        peak_close(g, w, 1e-6, "scaled draws")
    jm.rlg_auto_state, jm.rlg_diff_state = rlg_state(32, 0), rlg_state(128, 1)
    pm.rlg_auto = {k: torch.from_numpy(v) for k, v in jm.rlg_auto_state.items()}
    pm.rlg_diffuser = {k: torch.from_numpy(v) for k, v in jm.rlg_diff_state.items()}
    try:
        want = jm.get_random_conditioning_latents(key)
        with replayed([jax.random.normal(r1, (1, 32)), jax.random.normal(r2, (1, 128))]):
            got = pm.get_random_conditioning_latents(torch.Generator())
    finally:
        jm.rlg_auto_state = jm.rlg_diff_state = pm.rlg_auto = pm.rlg_diffuser = None
    assert got[0].shape == (1, 1, 32) and got[1].shape == (1, 128)
    for g, w in zip(got, want):
        peak_close(g, w, 1e-5, "generated latents")


# ---------------------------------------------------------------------------
# inference: F45, and the whole call on given codes
# ---------------------------------------------------------------------------


def calm_codes():
    """Codes that speak 21 codes, then fall silent (a run of calm codes)."""
    codes = np.random.RandomState(10).randint(0, 83, (1, 48))
    codes[0, 21:] = tortoise.CALM_TOKEN
    return codes


def inference_on_codes(jm, pm, codes, text, cond, dcond, monkeypatch, key):
    """Both ``inference`` calls with the AR decode replaced by ``codes``
    (the JAX package's cached ``generate`` program, the port's method)."""
    a = jm.config.model_args
    T = codes.shape[1]
    jm._jit[("generate", T, a.temperature, a.top_p, a.repetition_penalty)] = \
        lambda p, c, t, r: {"codes": jnp.asarray(codes), "latents": None,
                            "lengths": jnp.asarray([T])}
    want = jm.inference(jnp.asarray(text), jnp.asarray(cond), rng=key, max_mel_tokens=T,
                        diffusion_cond_mels=jnp.asarray(dcond))
    monkeypatch.setattr(pm.autoregressive, "generate", lambda *args, **kwargs: {
        "codes": torch.from_numpy(codes), "latents": None, "lengths": torch.tensor([T])})
    _, r2 = jax.random.split(key)
    T_mel = want["mel"].shape[1]
    draws = [jax_initial_noise(r2, (1, T_mel, 100)),
             jax.random.normal(jax.random.fold_in(r2, 1), (1, T_mel + 10, 8))]
    return want, draws


def test_f45_latents_cut_exactly_at_the_end_of_speech(pair, monkeypatch):
    """F45. Codes whose speech ends at code 21 (a calm run follows, and the
    end of speech is where it passes 8 codes: code 29): the JAX package
    rounds the cut up to 32 codes (``diffusion_length_bucket``, read with
    ``getattr``), 139 mel frames for 126; the port cuts at 29 codes, as the
    reference does. With the bucket set to 1 on the JAX instance the two
    agree on the JAX draws: the mel within 1e-4 of its peak, and the port's
    vocoding of the JAX mel within 1e-4 of the JAX waveform's peak. (The
    port's own waveform carries its mel's difference through the vocoder:
    the first DDIM step multiplies the denoiser's fp32 rounding by ~150, see
    ``test_samplers_match_jax_on_its_noise``.)"""
    jm, pm = pair
    codes = calm_codes()
    text, cond, dcond = ar_inputs(seed=11, B=1)[1], ar_inputs(seed=11, B=1)[0], \
        np.random.RandomState(12).randn(1, 30, 100).astype(np.float32)
    key = jax.random.PRNGKey(6)
    bucketed, _ = inference_on_codes(jm, pm, codes, text, cond, dcond, monkeypatch, key)
    assert bucketed["mel"].shape[1] == 32 * 4 * 24000 // 22050
    jm.config.model_args.diffusion_length_bucket = 1
    try:
        want, draws = inference_on_codes(jm, pm, codes, text, cond, dcond, monkeypatch, key)
    finally:
        del jm.config.model_args.diffusion_length_bucket
    assert want["mel"].shape[1] == 29 * 4 * 24000 // 22050 == 126
    with replayed(draws):
        got = pm.inference(torch.from_numpy(text), torch.from_numpy(cond),
                           max_mel_tokens=codes.shape[1],
                           diffusion_cond_mels=torch.from_numpy(dcond))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    peak_close(got["mel"], want["mel"], 1e-4, "mel")
    assert got["wav"].shape == (1, 126 * 256) and torch.isfinite(got["wav"]).all()
    with replayed(draws[1:]):
        wav = pm.vocode(torch.from_numpy(np.array(want["mel"])), torch.Generator())
    peak_close(wav, want["wav"], 1e-4, "waveform of the JAX mel")


# ---------------------------------------------------------------------------
# converters and the reference layout
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield "/".join(path), np.asarray(tree)


def test_converters_match_jax_and_the_reference_layout_round_trips(pair):
    """The port's reference-layout writers give states that the port's
    converters (copies of the JAX package's) and the JAX converters turn
    into the same flax trees, leaf for leaf, which carry back into the
    port's weights exactly."""
    _, pm = pair
    cases = [
        ("autoregressive", convert.reference_unified_voice_state, "convert_unified_voice",
         dict(layers=2)),
        ("diffusion", convert.reference_diffusion_state, "convert_diffusion_decoder",
         dict(num_layers=2)),
        ("clvp", convert.reference_clvp_state, "convert_clvp", dict(depth=2)),
        ("vocoder", convert.reference_tortoise_univnet_state, "convert_tortoise_univnet", {}),
    ]
    for name, write, conv, kw in cases:
        state = getattr(pm, name).state_dict()
        ref = write(state)
        got = dict(_leaves(getattr(convert, conv)(ref, **kw)))
        want = dict(_leaves(getattr(jax_convert, conv)(ref, **kw)))
        assert sorted(got) == sorted(want), name
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        back = convert.flax_to_state_dict(getattr(convert, conv)(ref, **kw))
        assert set(back) == set(state), name
        for key, value in state.items():
            assert torch.equal(back[key], value), (name, key)
