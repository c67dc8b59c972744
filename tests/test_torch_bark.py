"""tts_tpu_torch Bark against the JAX package's (``tts_tpu.models.bark``) on
the CPU, module by module, at a small size: three GPTs of 2 layers 32 wide
with 2 heads (the semantic model's head 104 wide over a 384-token input, as
the published text model's head is narrower than its input; the coarse
model over 144 tokens; the fine model over 20, 4 codebooks), 16-entry
codebooks, and a small EnCodec (HF ``EncodecModel`` at ``_small_config``'s
dims: ratios (4, 2), 32-entry codebooks 16 wide).

Both packages load the same weights: flax params drawn at unit gain
(``test_torch_tortoise.drawn``), carried into the port by
``bark_from_jax_params``; EnCodec from the HF model's state dict through
each package's converters. The JAX modules run under ``jax.jit`` where a
call repeats.

Tolerances (fp32): logits within 1e-5 of their peak, EnCodec's waveforms
and latents within 1e-4 of their peak. The autoregressive stages are held
token for token greedily: ``greedy()`` swaps both packages' ``sample_logits``
for an argmax, and the fine stage runs at ``temperature=None`` (argmax in
both). F48 (a head narrower than the config's vocabulary) and F51 (the
``_orig_mod.`` prefix) are named here.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tortoise import _leaves, drawn, peak_close

from tts_tpu.models.bark import encodec as jax_encodec
from tts_tpu.models.bark import model as jax_model
from tts_tpu.models.bark.config import BarkConfig as JaxConfig
from tts_tpu.models.bark.config import BarkGPTArgs as JaxArgs
from tts_tpu.models.xtts import gpt_core as jax_core
from tts_tpu.utils import convert as jax_convert
from tts_tpu_torch.models.bark import encodec
from tts_tpu_torch.models.bark import model as bark
from tts_tpu_torch.models.bark.config import BarkConfig
from tts_tpu_torch.models.xtts.gpt_core import GPT2Core
from tts_tpu_torch.utils import convert

tfe = pytest.importorskip("transformers.models.encodec.modeling_encodec")

# the small model's constants: semantic ids [0, 100), EOS and pad 100, text
# bytes at 104 + [0, 256); coarse codes [100, 132), its pad and infer
# tokens 132 and 134; fine codes [0, 16), pad 16
CONSTANTS = dict(SEMANTIC_VOCAB_SIZE=100, SEMANTIC_PAD_TOKEN=100, TEXT_ENCODING_OFFSET=104,
                 TEXT_PAD_TOKEN=380, SEMANTIC_INFER_TOKEN=383, CODEBOOK_SIZE=16,
                 COARSE_SEMANTIC_PAD_TOKEN=132, COARSE_INFER_TOKEN=134, N_FINE_CODEBOOKS=4)
GPT = dict(block_size=640, n_layer=2, n_head=2, n_embd=32)


def tiny_config():
    cfg = JaxConfig(**CONSTANTS)
    cfg.semantic_config = JaxArgs(input_vocab_size=384, output_vocab_size=104, **GPT)
    cfg.coarse_config = JaxArgs(input_vocab_size=144, output_vocab_size=144, **GPT)
    cfg.fine_config = JaxArgs(input_vocab_size=20, output_vocab_size=20, n_codes_total=4,
                              n_codes_given=1, **GPT)
    return cfg


def small_encodec_config():
    return tfe.EncodecConfig(
        target_bandwidths=[16.0], sampling_rate=1600, audio_channels=1, num_filters=4,
        hidden_size=16, upsampling_ratios=[4, 2], codebook_size=32, codebook_dim=16,
        kernel_size=5, last_kernel_size=5, residual_kernel_size=3, num_lstm_layers=2,
        num_residual_layers=1)


@functools.lru_cache(maxsize=None)
def encodec_state(seed=0):
    """A small HF ``EncodecModel``'s random state dict (numpy)."""
    torch.manual_seed(seed)
    ref = tfe.EncodecModel(small_encodec_config()).eval()
    return {k: v.detach().numpy() for k, v in ref.state_dict().items()}


def jax_tiny(seed=0, with_encodec=True, tmp_path=None):
    """A small JAX ``Bark`` with drawn weights; EnCodec loaded from a saved
    HF state dict when ``tmp_path`` is given."""
    jm = jax_model.Bark(tiny_config())
    jm.semantic_params, jm.coarse_params, jm.fine_params = drawn(
        lambda: jm.init_params(jax.random.PRNGKey(0)), seed=seed)
    if with_encodec and tmp_path is not None:
        path = tmp_path / "encodec_24khz.pth"
        torch.save({k: torch.from_numpy(v) for k, v in encodec_state().items()}, path)
        jm.load_encodec(str(path))
    return jm


def port_of(jm):
    """The port's ``Bark`` on ``jm``'s weights (CPU)."""
    pm = bark.Bark(BarkConfig.from_dict(jm.config.to_dict()))
    states = convert.bark_from_jax_params(jm.semantic_params, jm.coarse_params, jm.fine_params,
                                          jm.encodec_vocoder)
    if "encodec" in states:
        pm.encodec = convert.load_reference_encodec(encodec_state(), device="cpu")
    for name, state in states.items():
        getattr(pm, name).load_state_dict(state, strict=True)
    return pm.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jm = jax_tiny(tmp_path=tmp_path_factory.mktemp("bark"))
    return jm, port_of(jm)


@contextlib.contextmanager
def greedy():
    """Both packages' AR sampling as an argmax (the JAX one traced afresh:
    callers use a model whose stages have not been jitted yet, or clear
    its ``_jit_cache``)."""
    jax_sample, port_sample = jax_model.sample_logits, bark.sample_logits
    jax_model.sample_logits = lambda rng, lg, **kw: jnp.argmax(lg, axis=-1)
    bark.sample_logits = lambda lg, generator, **kw: torch.argmax(lg, dim=-1)
    try:
        yield
    finally:
        jax_model.sample_logits, bark.sample_logits = jax_sample, port_sample


# ---------------------------------------------------------------------------
# the core's variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias,gelu_exact", [(False, True), (True, True), (True, False)])
def test_core_variants_and_masks_match_jax(bias, gelu_exact):
    """``GPT2Core(bias, gelu_exact)`` against the JAX core with
    ``use_bias``/``gelu_exact``: causal, under the coarse window's mask over
    the cache (``col <= row`` and ``col < valid_len``; the JAX prefill
    attends over the whole ``max_len`` cache under it), the fine model's
    full mask, and one decode step behind the masked prefill."""
    T, max_len, valid = 12, 16, 9
    jc = jax_core.GPT2Core(layers=2, dim=32, heads=2, use_bias=bias, gelu_exact=gelu_exact,
                           use_pallas=False)
    x = np.random.RandomState(0).randn(1, T, 32).astype(np.float32)
    params = drawn(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, T, 32)), seed=1)
    pc = GPT2Core(2, 32, 2, bias=bias, gelu_exact=gelu_exact)
    pc.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    assert (pc.ln_f.bias is None) == (not bias)

    want, _ = jc.apply(params, jnp.asarray(x), attn_mask=jax_core.causal_mask(T))
    with torch.no_grad():
        peak_close(pc(torch.from_numpy(x)), want, 1e-5, "causal")
        full = jnp.ones((1, 1, T, T), bool)
        want, _ = jc.apply(params, jnp.asarray(x), attn_mask=full)
        peak_close(pc(torch.from_numpy(x), causal=False,
                      attn_mask=torch.ones(T, T, dtype=torch.bool)), want, 1e-5, "full")

        rows, cols = np.arange(T), np.arange(max_len)
        mask = (cols[None] <= rows[:, None]) & (cols[None] < valid)
        caches = jc.init_cache(1, max_len)
        want, caches = jc.apply(params, jnp.asarray(x), attn_mask=jnp.asarray(mask)[None, None],
                                caches=caches, cache_index=0)
        cache = pc.init_cache(1, max_len)
        got = pc(torch.from_numpy(x), cache=cache, attn_mask=torch.from_numpy(mask[:, :T]))
        peak_close(got, want, 1e-5, "window mask")
        # decode at valid_len: the tail's masked slots are overwritten first
        y = np.random.RandomState(1).randn(1, 1, 32).astype(np.float32)
        want, _ = jc.apply(params, jnp.asarray(y), caches=caches, cache_index=valid,
                           cache_len=valid + 1)
        got = pc(torch.from_numpy(y), cache=cache, cache_index=valid, cache_len=valid + 1)
        peak_close(got, want, 1e-5, "decode step")


# ---------------------------------------------------------------------------
# the GPTs
# ---------------------------------------------------------------------------


def test_jax_params_carry_over_strictly(pair):
    jm, pm = pair
    for name, params in (("semantic_model", jm.semantic_params),
                         ("coarse_model", jm.coarse_params), ("fine_model", jm.fine_params)):
        state = getattr(pm, name).state_dict()
        assert set(state) == set(convert.flax_to_state_dict(params))
    assert "lm_head_3.weight" in pm.fine_model.state_dict()
    assert pm.semantic_model.core.h[0].ln_1.bias is None  # bias=False
    assert pm.fine_model.core.h[0].ln_1.bias is not None  # the fine core keeps its biases


@pytest.mark.parametrize("merge_context", [True, False])
def test_prefill_logits_match_jax(pair, merge_context):
    jm, pm = pair
    idx = np.random.RandomState(2).randint(0, 384, (2, 256 + 256 + 7))
    want, _ = jm.semantic_model.apply(jm.semantic_params, jnp.asarray(idx),
                                      merge_context=merge_context)
    got = pm.semantic_model(torch.from_numpy(idx), merge_context=merge_context)
    peak_close(got, want, 1e-5, "semantic prefill")


@pytest.mark.parametrize("pred_idx", [1, 2, 3])
def test_fine_logits_match_jax(pair, pred_idx):
    jm, pm = pair
    idx = np.random.RandomState(3).randint(0, 17, (1, 50, 4))
    want = jm.fine_model.apply(jm.fine_params, pred_idx, jnp.asarray(idx))
    peak_close(pm.fine_model(pred_idx, torch.from_numpy(idx)), want, 1e-5, "fine")


def test_position_table_is_not_passed(pair):
    """The JAX ``dynamic_slice`` would clamp positions past the table; the
    port raises."""
    _, pm = pair
    with pytest.raises(ValueError, match="position table"):
        pm.semantic_model(torch.zeros(1, 5, dtype=torch.long), position_offset=638)


def jax_generate(jm, prompt, **kw):
    fn = jax.jit(functools.partial(jm.semantic_model.apply, method=jm.semantic_model.generate,
                                   **kw))
    out = fn(jm.semantic_params, jnp.asarray(prompt), jax.random.PRNGKey(0))
    return np.asarray(out["tokens"]), np.asarray(out["lengths"])


def test_greedy_generate_and_early_stop_match_jax(pair):
    """``BarkGPT.generate`` with two rows: greedy tokens and lengths equal
    the JAX loop's, with an EOS neither row emits (every step runs) and
    with the token row 0 emits at step 5 and row 1 later; the port's loop
    then stops at the first read of its done flags after both rows are
    done."""
    jm, pm = pair
    prompt = np.random.RandomState(4).randint(0, 384, (2, 20))
    kw = dict(max_new_tokens=40, logit_slice=101)
    with greedy():
        want, want_len = jax_generate(jm, prompt, eos_token=200, **kw)
        out = pm.semantic_model.generate(torch.from_numpy(prompt), None, eos_token=200, **kw)
        np.testing.assert_array_equal(out["tokens"].numpy(), want)
        np.testing.assert_array_equal(out["lengths"].numpy(), want_len)
        assert (want_len == 40).all()
        eos = int(want[0, 5])
        firsts = [int(np.flatnonzero(want[r] == eos)[0]) if (want[r] == eos).any() else 40
                  for r in range(2)]
        want, want_len = jax_generate(jm, prompt, eos_token=eos, **kw)
        steps = pm.semantic_model.decode_steps
        out = pm.semantic_model.generate(torch.from_numpy(prompt), None, eos_token=eos, **kw)
        ran = pm.semantic_model.decode_steps - steps
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    np.testing.assert_array_equal(out["lengths"].numpy(), want_len)
    assert list(want_len) == firsts
    last = max(firsts) + 1
    assert ran == min(40, -(-last // bark.DONE_CHECK_EVERY) * bark.DONE_CHECK_EVERY)


# ---------------------------------------------------------------------------
# the three stages
# ---------------------------------------------------------------------------


def voice_prompt(seed=0, n_sem=40, n_codes=120):
    rs = np.random.RandomState(seed)
    return {"semantic_prompt": rs.randint(0, 100, n_sem).astype(np.int64),
            "coarse_prompt": rs.randint(0, 16, (2, n_codes)).astype(np.int64),
            "fine_prompt": rs.randint(0, 16, (4, n_codes)).astype(np.int64)}


@pytest.fixture
def fresh(pair):
    """The pair with the JAX stages' jit cache emptied (``greedy`` must be
    traced in)."""
    jm, pm = pair
    jm._jit_cache.clear()
    yield jm, pm
    jm._jit_cache.clear()


@pytest.mark.parametrize("history", [False, True])
def test_semantic_stage_tokens_identical(fresh, history):
    jm, pm = fresh
    hist = voice_prompt()["semantic_prompt"] if history else None
    text = np.frombuffer("Hello there.".encode(), np.uint8).astype(np.int64)
    with greedy():
        want = jm.generate_text_semantic(text, jax.random.PRNGKey(1), max_gen_duration_s=0.6,
                                         semantic_history=hist)
        got = pm.generate_text_semantic(text, None, max_gen_duration_s=0.6,
                                        semantic_history=hist)
    np.testing.assert_array_equal(got, want)
    assert len(got) == int(0.6 * 49.9)  # random weights never emit EOS


@pytest.mark.parametrize("history", [False, True])
def test_coarse_stage_tokens_identical(fresh, history):
    """Several windows (60 steps each; the tail 323 wide at block 640), the
    voice prompt's trimmed and interleaved history in front."""
    jm, pm = fresh
    p = voice_prompt()
    hist = (p["semantic_prompt"], p["coarse_prompt"]) if history else None
    sem = np.random.RandomState(6).randint(0, 100, 90)
    with greedy():
        want = jm.generate_coarse(sem, jax.random.PRNGKey(2), history=hist)
        got = pm.generate_coarse(sem, None, history=hist)
    assert want.shape == (2, 135) and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_coarse_stage_never_reads_stale_cache_slots(fresh, monkeypatch):
    """Every cache slot the coarse windows attend to was written in their
    own window: a cache that starts full of garbage gives the same tokens
    as the JAX package's zeroed one."""
    jm, pm = fresh
    init = GPT2Core.init_cache

    def garbage(self, *args, **kwargs):
        cache = init(self, *args, **kwargs)
        for t in cache.k + cache.v:
            t.normal_(0, 100.0)
        return cache

    monkeypatch.setattr(GPT2Core, "init_cache", garbage)
    sem = np.random.RandomState(7).randint(0, 100, 60)
    with greedy():
        want = jm.generate_coarse(sem, jax.random.PRNGKey(2), history=None)
        got = pm.generate_coarse(sem, None, history=None)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["short", "history", "long"])
def test_fine_stage_codes_identical(pair, case):
    """One window, one behind a voice prompt's 320 in-context frames, and
    700 frames (three 640-wide windows at a 320 hop); the coarse rows pass
    through and every code lies in the codebook."""
    jm, pm = pair
    rs = np.random.RandomState(8)
    t_gen = 700 if case == "long" else 90
    coarse = rs.randint(0, 16, (2, t_gen)).astype(np.int32)
    hist = rs.randint(0, 16, (4, 400)).astype(np.int32) if case != "short" else None
    want = jm.generate_fine(coarse, jax.random.PRNGKey(3), temperature=None, history=hist)
    got = pm.generate_fine(coarse, None, temperature=None, history=hist)
    np.testing.assert_array_equal(got, want)
    assert (got[:2] == coarse).all() and got.min() >= 0 and got.max() < 16


def test_fine_stage_samples_from_its_generator(pair):
    """At a temperature the fine codes are drawn from the generator: the
    same seed gives the same codes, another seed others."""
    _, pm = pair
    coarse = np.random.RandomState(9).randint(0, 16, (2, 50))
    a = pm.generate_fine(coarse, torch.Generator().manual_seed(0))
    b = pm.generate_fine(coarse, torch.Generator().manual_seed(0))
    c = pm.generate_fine(coarse, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and a.max() < 16


# ---------------------------------------------------------------------------
# EnCodec
# ---------------------------------------------------------------------------


def jax_small_decoder():
    return jax_encodec.EncodecDecoder(hidden_size=16, num_filters=4, upsampling_ratios=(4, 2),
                                      kernel_size=5, last_kernel_size=5)


@pytest.mark.parametrize("frames", [12, 1])
def test_encodec_decoder_matches_jax(pair, frames):
    """Latents ``[1, 16, T]`` → wav, through the port's decoder and the JAX
    one on the same converted weights; 1 frame takes the reflect padding's
    guard for inputs shorter than the padding."""
    _, pm = pair
    params, _ = jax_convert.convert_encodec_decoder(encodec_state(), upsampling_ratios=(4, 2))
    lat = np.random.RandomState(10).randn(1, 16, frames).astype(np.float32)
    want = jax_small_decoder().apply(params, jnp.asarray(lat.transpose(0, 2, 1)))
    got = pm.encodec.decoder(torch.from_numpy(lat))
    assert got.shape == (1, 1, frames * 8)
    peak_close(got[0, 0], np.asarray(want)[0, :, 0], 1e-4, "decoder")


def test_rvq_decode_and_vocoder_match_jax(pair):
    jm, pm = pair
    codes = np.random.RandomState(11).randint(0, 32, (4, 9))
    want_lat = jax_encodec.rvq_decode(codes, jm.encodec_vocoder.codebooks)
    got_lat = encodec.rvq_decode(torch.from_numpy(codes), pm.encodec.codebooks)
    peak_close(got_lat[0].T, np.asarray(want_lat)[0], 1e-6, "rvq latents")
    peak_close(pm.encodec.decode(codes), jm.encodec_vocoder.decode(codes), 1e-4, "vocoder")
    assert pm.encodec.hop == 8 and pm.encodec.n_q == jm.encodec_vocoder.n_q


def test_codes_outside_the_codebooks_raise(pair):
    """The JAX gather clamps a code past the codebook; the port raises."""
    _, pm = pair
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        pm.encodec.decode(np.full((4, 3), 32))
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        pm.encodec.decode(np.full((4, 3), -1))


# ---------------------------------------------------------------------------
# converters and the reference layout
# ---------------------------------------------------------------------------


def reference_gpt_state(pm, name):
    return convert.reference_bark_gpt_state(getattr(pm, name).state_dict())


def test_converters_match_jax(pair):
    """The port's copies of ``convert_bark_gpt``, ``convert_bark_fine``, the
    EnCodec converters and ``infer_encodec_dims`` against the JAX ones, leaf
    for leaf, on reference-layout state dicts (nanoGPT names; HF
    ``EncodecModel``'s, and the original ``encodec`` package's names)."""
    _, pm = pair
    sem = reference_gpt_state(pm, "semantic_model")
    fine = reference_gpt_state(pm, "fine_model")
    enc = encodec_state()
    original = {k.replace("decoder.layers.", "decoder.model.").replace(
        "quantizer.layers.", "quantizer.vq.layers."): v for k, v in enc.items()}
    pairs = [
        (convert.convert_bark_gpt(sem, 2), jax_convert.convert_bark_gpt(sem, 2)),
        (convert.convert_bark_fine(fine, 2, 4, 1), jax_convert.convert_bark_fine(fine, 2, 4, 1)),
        (convert.convert_encodec_encoder(enc, (4, 2)),
         jax_convert.convert_encodec_encoder(enc, (4, 2))),
    ]
    for state in (enc, original):
        ours, theirs = convert.convert_encodec_decoder(state, (4, 2)), \
            jax_convert.convert_encodec_decoder(state, (4, 2))
        pairs.append((ours[0], theirs[0]))
        np.testing.assert_array_equal(ours[1], theirs[1])
        assert convert.infer_encodec_dims(state) == jax_convert.infer_encodec_dims(state)
    for ours, theirs in pairs:
        a, b = dict(_leaves(ours)), dict(_leaves(theirs))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_reference_layout_round_trips(pair):
    """The reference writers invert the loaders: nanoGPT-named GPT states
    through ``convert_bark_gpt``/``convert_bark_fine`` and HF-named EnCodec
    states through ``load_reference_encodec`` give the port's weights back
    exactly."""
    _, pm = pair
    for name, conv in (("semantic_model", lambda s: convert.convert_bark_gpt(s, 2)),
                       ("fine_model", lambda s: convert.convert_bark_fine(s, 2, 4, 1))):
        back = convert.flax_to_state_dict(conv(reference_gpt_state(pm, name)))
        want = getattr(pm, name).state_dict()
        assert set(back) == set(want)
        assert all(torch.equal(back[k], want[k]) for k in want)
    state = convert.reference_encodec_state(pm.encodec.state_dict())
    # HF's names, weight norm folded, the codebooks' training buffers left out
    assert set(state) == {k for k in convert.fold_weight_norm(encodec_state())
                          if not k.startswith("quantizer.") or k.endswith(".codebook.embed")}
    back = convert.load_reference_encodec(state, device="cpu").state_dict()
    want = pm.encodec.state_dict()
    assert set(back) == set(want) and all(torch.equal(back[k], want[k]) for k in want)


def write_bark_dir(d, pm, prefix="", with_encodec=True):
    """``pm``'s weights as the reference's bark directory."""
    d.mkdir(parents=True, exist_ok=True)
    for name, fname in (("semantic_model", "text_2.pt"), ("coarse_model", "coarse_2.pt"),
                        ("fine_model", "fine_2.pt")):
        state = reference_gpt_state(pm, name)
        torch.save({"model": {prefix + k: torch.from_numpy(v) for k, v in state.items()},
                    "model_args": getattr(pm, name).args.to_dict()}, d / fname)
    if with_encodec:
        torch.save({k: torch.from_numpy(v) for k, v in
                    convert.reference_encodec_state(pm.encodec.state_dict()).items()},
                   d / "encodec_24khz.pth")
    (d / "config.json").write_text(__import__("json").dumps(pm.config.to_dict(), default=list))


def test_f48_head_width_is_read_from_the_checkpoint(pair, tmp_path):
    """F48: the semantic head (104 wide, as the published text model's is
    10,048 over a 129,600-token input) is narrower than the config's
    default, which the JAX loader builds, so its model fails on the head's
    shape; the port's loader reads both vocabularies (and the position
    table) from the checkpoint and matches the JAX model built at the head's
    real width."""
    jm, pm = pair
    write_bark_dir(tmp_path, pm)
    cfg = tiny_config()
    cfg.semantic_config.output_vocab_size = 384  # the config's: input and output alike
    loaded = bark.Bark(BarkConfig.from_dict(cfg.to_dict())).load_checkpoint(
        checkpoint_dir=str(tmp_path), device="cpu")
    assert loaded.semantic_model.lm_head.out_features == 104
    assert loaded.semantic_model.wte.num_embeddings == 384
    bad = jax_model.Bark(cfg)
    jax_model.load_bark_checkpoint(bad, str(tmp_path))
    idx = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(Exception, match="lm_head"):
        bad.semantic_model.apply(bad.semantic_params, idx)
    want, _ = jm.semantic_model.apply(jm.semantic_params, idx)
    peak_close(loaded.semantic_model(torch.zeros(1, 8, dtype=torch.long)), want, 1e-5, "F48")


def test_f51_compiled_prefix_is_stripped(pair, tmp_path):
    """F51: state dicts saved from a compiled model carry ``_orig_mod.``
    before every key; the port's loader strips it (the JAX loader raises
    ``KeyError``). A checkpoint of another depth than the config's raises."""
    jm, pm = pair
    write_bark_dir(tmp_path, pm, prefix="_orig_mod.")
    loaded = bark.Bark(pm.config).load_checkpoint(checkpoint_dir=str(tmp_path), device="cpu")
    for name in ("semantic_model", "coarse_model", "fine_model", "encodec"):
        want, got = getattr(pm, name).state_dict(), getattr(loaded, name).state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(KeyError, match="transformer"):
        jax_model.load_bark_checkpoint(jax_model.Bark(jm.config), str(tmp_path))
    cfg = BarkConfig.from_dict(pm.config.to_dict())
    cfg.coarse_config.n_layer = 3
    with pytest.raises(ValueError, match="2 layers, the config says 3"):
        bark.Bark(cfg).load_checkpoint(checkpoint_dir=str(tmp_path), device="cpu")
