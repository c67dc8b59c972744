"""int8 weight-only serving (``tts_tpu_torch.ops.quant``) in XTTS (v2 and
v1), Tortoise and Bark against the JAX package's, on the CPU.

Widths are chosen so that every matmul weight the models run, the heads
included, holds at least the 4096 elements that ``quantize_int8`` asks for:
XTTS 2 layers 64 wide with 80 audio and 70 text tokens, Tortoise's AR model
2 layers 64 wide (heads 100 and 256 wide; its conditioning encoder's 1x1
convolutions are 3-D kernels), Bark's three GPTs 2 layers 64 wide (the fine
model's 20-wide heads stay float in both packages). The JAX side quantizes
with ``compute_dtype=float32`` and runs as its own tests run it; the port
runs K4's plain version (CPU tensors).

Both packages quantize the same set of weights to the same int8 values and
scales: the JAX quantized tree carried by the port's converters equals the
port's own quantized state, bit for bit. Conditioning latents, prefill and
teacher-forced logits agree within 1e-5 of their peak (fp32; the port
applies the scale after the sum, the JAX package before it), decoded tokens
are identical under argmax decoding (XTTS ``top_k=1``, Tortoise ``top_p``
1e-6, Bark's ``greedy()``), and the quantized models hold no float copy of
a quantized weight. The XTTS flag goes through ``config.json``,
``load_checkpoint``, the ``Synthesizer`` and ``TTS``.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import test_torch_bark as tb
import test_torch_tortoise as tt
from helpers import fast_init_model, tiny_xtts_config
from test_torch_tortoise import peak_close

from tts_tpu.models.bark import model as jax_bark
from tts_tpu.models.bark.config import BarkConfig as JaxBarkConfig
from tts_tpu.models.bark.config import BarkGPTArgs as JaxBarkArgs
from tts_tpu.models.tortoise import model as jax_tortoise
from tts_tpu.models.xtts import Xtts as JaxXtts
from tts_tpu.ops import quant as jax_quant
from tts_tpu_torch.api import TTS
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
from tts_tpu_torch.ops import quant
from tts_tpu_torch.utils import convert

REL = 1e-5
WAV_ATOL = 1e-4
TEXT = "hello there."


def assert_same_state(got: dict, want: dict):
    """Same keys, dtypes and values, bit for bit."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def int8_keys(state: dict) -> set:
    return {k[: -len(".weight_int8")] for k in state if k.endswith(".weight_int8")}


def no_float_copy(module: nn.Module, float_bytes: int):
    """No Linear or Conv1d of quantizable size is left, and the module's
    bytes are its fp32 bytes less 3 of every quantized weight's 4 bytes an
    element, plus the scales: nothing else stays resident."""
    assert not any(type(m) in (nn.Linear, nn.Conv1d) and m.weight.numel() >= quant.MIN_ELEMS
                   for m in module.modules())
    int8 = [m for m in module.modules() if isinstance(m, (quant.Int8Linear, quant.Int8Conv1d))]
    assert int8
    saved = sum(3 * m.weight_int8.numel() - 4 * m.scale.numel() for m in int8)
    assert quant.quantized_bytes(module) == float_bytes - saved


# ---------------------------------------------------------------------------
# XTTS through config.json, load_checkpoint, the Synthesizer and TTS
# ---------------------------------------------------------------------------


def xtts_config(layout: str):
    config = tiny_xtts_config()
    a = config.model_args
    a.gpt_num_audio_tokens, a.gpt_start_audio_token, a.gpt_stop_audio_token = 80, 78, 79
    a.gpt_number_text_tokens = 70
    a.gpt_use_perceiver_resampler = layout == "v2"
    a.gpt_int8_weights = True
    config.top_k = 1  # argmax decoding in both packages
    return config


def reference_clip(seconds=1.5, seed=0):
    t = np.arange(int(seconds * 22050), dtype=np.float32) / 22050.0
    noise = 0.05 * np.random.RandomState(seed).randn(len(t)).astype(np.float32)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + noise).astype(np.float32)


_BUILT = {}


def built_xtts(layout: str, tmp_path_factory):
    """A model directory whose ``config.json`` sets ``gpt_int8_weights``
    (float weights in ``model_flax.msgpack`` and ``model_torch.pt``), the
    JAX ``Xtts`` and the port's ``Xtts`` each loaded from it, and the fp32
    bytes of the port's GPT before quantization; built once a layout."""
    if layout not in _BUILT:
        _BUILT[layout] = _build_xtts(layout, tmp_path_factory.mktemp(f"xtts_int8_{layout}"))
    return _BUILT[layout]


def _build_xtts(layout, d):
    from tts_tpu.audio.numpy_transforms import save_wav
    from tts_tpu.utils.io import save_checkpoint

    config = xtts_config(layout)
    seed = JaxXtts(config)
    gpt_params, decoder_params = fast_init_model(
        seed, jax.random.PRNGKey(0), attrs=("gpt_params", "decoder_params"), scale=0.04)
    gpt_params = flax.core.unfreeze(gpt_params)
    head = gpt_params["params"]["mel_head"]  # the stop token never wins: every step decodes
    head["bias"] = jnp.asarray(head["bias"]).at[config.model_args.gpt_stop_audio_token].set(-1e4)
    save_checkpoint(str(d / "model_flax.msgpack"),
                    {"gpt": gpt_params, "decoder": decoder_params, "mel_stats": np.zeros((0,))},
                    config=config)
    with open(d / "config.json", "w") as f:
        json.dump(config.to_dict(), f, default=str)
    write_char_vocab(str(d / "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'")
    float_port = Xtts(XttsConfig.from_dict(config.to_dict()))
    float_port.load_state_dict_with_stats(convert.xtts_from_jax_params(gpt_params, decoder_params))
    torch.save(float_port.state_dict_with_stats(), d / "model_torch.pt")
    save_wav(wav=reference_clip(), path=str(d / "ref.wav"), sample_rate=22050)

    jm = JaxXtts(config)
    jm.load_checkpoint(config, checkpoint_dir=str(d))
    tm = Xtts(XttsConfig.from_dict(config.to_dict()))
    tm.load_checkpoint(tm.config, checkpoint_dir=str(d), device="cpu")
    return jm, tm, d, quant.quantized_bytes(float_port.gpt)


@pytest.fixture(scope="module", params=["v2", "v1"])
def xtts(request, tmp_path_factory):
    return built_xtts(request.param, tmp_path_factory)


def test_xtts_flag_quantizes_what_jax_quantizes(xtts):
    """``load_checkpoint`` under the flag quantizes in both packages; the
    JAX quantized tree carried over is the port's state, bit for bit, and
    every weight of at least 4096 elements (both heads included) is in it."""
    jm, tm, _, _ = xtts
    assert jax_quant.is_quantized(jm.gpt_params) and quant.is_quantized(tm.gpt)
    assert not quant.is_quantized(tm.hifigan_decoder)
    carried = convert.xtts_from_jax_params(jm.gpt_params, jm.decoder_params)
    assert_same_state(tm.state_dict(), carried)
    names = int8_keys(carried)
    assert {"gpt.mel_head", "gpt.text_head", "gpt.conditioning_encoder.init",
            "gpt.gpt.h.0.attn.c_proj"} <= names  # c_proj is 64 x 64: exactly 4096
    if tm.gpt.conditioning_perceiver is not None:
        assert "gpt.conditioning_perceiver.to_kv.1" in names


def test_xtts_int8_holds_no_float_copy(xtts):
    _, tm, _, float_bytes = xtts
    no_float_copy(tm.gpt, float_bytes)
    assert quant.quantized_bytes(tm.gpt) < float_bytes / 3
    assert tm.gpt.dtype == torch.float32 and tm.device.type == "cpu"


def test_xtts_int8_conditioning_prefill_and_tokens_match_jax(xtts):
    """The reference clip's conditioning latents (perceiver, or one a coarse
    mel frame in v1), the prefill's logits, and 12 tokens decoded at
    ``top_k=1`` with their latents."""
    jm, tm, _, _ = xtts
    audio = reference_clip()
    want_cond = np.asarray(jm.get_gpt_cond_latents(audio, 22050))
    cond = tm.get_gpt_cond_latents(audio, 22050)
    peak_close(cond, want_cond, REL, "conditioning latents")
    text = np.random.RandomState(3).randint(1, 40, (2, 9))
    lengths = np.array([9, 6])
    params = jm._dq(jm.gpt_params)
    c = jnp.broadcast_to(jnp.asarray(want_cond), (2,) + want_cond.shape[1:])
    want = jm.gpt.apply(params, c, jnp.asarray(text), jnp.asarray(lengths),
                        max_new_tokens=12, method=jm.gpt.prefill)
    ct = torch.from_numpy(np.array(want_cond)).expand(2, -1, -1)
    got = tm.gpt.prefill(ct, torch.from_numpy(text), torch.from_numpy(lengths),
                         max_new_tokens=12)
    peak_close(got["last_logits"], want["last_logits"], REL, "prefill logits")
    want = jm.gpt.apply(params, c, jnp.asarray(text), jnp.asarray(lengths),
                        jax.random.PRNGKey(1), max_new_tokens=12, top_k=1,
                        method=jm.gpt.generate)
    got = tm.gpt.generate(ct, torch.from_numpy(text), torch.from_numpy(lengths), None,
                          max_new_tokens=12, top_k=1)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert len(set(np.asarray(want["codes"]).ravel().tolist())) > 3
    peak_close(got["latents"], want["latents"], REL, "latents")


def test_xtts_int8_synthesizer_and_tts_match_jax(tmp_path_factory):
    """The JAX ``Synthesizer`` and the port's ``TTS`` each load the v2 model
    directory (the flag from ``config.json``) and clone the voice: the same
    audio within 1e-4, whole and streamed."""
    from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer

    _, _, d, _ = built_xtts("v2", tmp_path_factory)
    ref = str(d / "ref.wav")
    jax_synth = JaxSynthesizer(model_dir=str(d))
    assert jax_quant.is_quantized(jax_synth.tts_model.gpt_params)
    port = TTS(model_path=str(d), device="cpu")
    assert quant.is_quantized(port.synthesizer.tts_model.gpt)
    want = np.asarray(jax_synth.tts(TEXT, language_name="en", speaker_wav=ref), np.float32)
    got = np.asarray(port.tts(TEXT, language="en", speaker_wav=ref), np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
    want = [np.asarray(c, np.float32) for c in
            jax_synth.tts_stream(TEXT, language_name="en", speaker_wav=ref)][0]
    got = next(iter(port.tts_stream(TEXT, language="en", speaker_wav=ref)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


# ---------------------------------------------------------------------------
# Tortoise: the UnifiedVoice AR stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tortoise():
    jm = tt.jax_tiny(ar_model_dim=64)
    pm = tt.port_of(jm, clvp=False, vocoder=False)
    float_bytes = quant.quantized_bytes(pm.autoregressive)
    jm.quantize_weights_int8(compute_dtype=jnp.float32)
    pm.quantize_weights_int8()
    return jm, pm, float_bytes


def test_tortoise_quantizes_what_jax_quantizes(tortoise):
    """The AR stack's tree (its conditioning encoder's 3-D conv kernels, the
    core, both heads) carried over equals the port's quantized state; the
    diffusion decoder stays float in both."""
    jm, pm, float_bytes = tortoise
    carried = convert.tortoise_from_jax_params(jm.ar_params, jm.diff_params)
    assert_same_state(pm.autoregressive.state_dict(), carried["autoregressive"])
    assert_same_state(pm.diffusion.state_dict(), carried["diffusion"])
    assert not jax_quant.is_quantized(jm.diff_params) and not quant.is_quantized(pm.diffusion)
    names = int8_keys(carried["autoregressive"])
    assert {"mel_head", "text_head", "conditioning_encoder.attn.0.qkv",
            "conditioning_encoder.attn.5.proj_out", "gpt.h.1.mlp_proj"} <= names
    assert isinstance(pm.autoregressive.conditioning_encoder.attn[0].qkv, quant.Int8Conv1d)
    no_float_copy(pm.autoregressive, float_bytes)


def test_tortoise_int8_conditioning_logits_and_tokens_match_jax(tortoise):
    jm, pm, _ = tortoise
    cond, text, codes = tt.ar_inputs()
    params = jm._dq(jm.ar_params)
    cl = np.array(tt.jitted(jm.autoregressive, jax_tortoise.UnifiedVoice.get_conditioning)(
        params, jnp.asarray(cond)))
    peak_close(pm.autoregressive.get_conditioning(torch.from_numpy(cond)), cl, REL,
               "AR conditioning")
    want = tt.jitted(jm.autoregressive)(params, jnp.asarray(cl), jnp.asarray(text),
                                        jnp.asarray(codes))
    with torch.no_grad():
        got = pm.autoregressive(torch.from_numpy(cl), torch.from_numpy(text),
                                torch.from_numpy(codes))
    for g, w, what in zip(got, want, ("text logits", "mel logits", "mel latents")):
        peak_close(g, w, REL, what)
    jm.ar_params = params  # greedy_jax reads the tree as it is: hand it the dequantized one
    try:
        want = tt.greedy_jax(jm, cl, text, 16)
    finally:
        jm.quantize_weights_int8(compute_dtype=jnp.float32)
    got = pm.autoregressive.generate(torch.from_numpy(cl), torch.from_numpy(text), None,
                                     max_new_tokens=16, temperature=0.8, top_p=1e-6,
                                     repetition_penalty=2.0)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert len(set(np.asarray(want["codes"])[0].tolist())) > 3
    peak_close(got["latents"], want["latents"], REL, "latents")


# ---------------------------------------------------------------------------
# Bark: the three GPTs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bark():
    cfg = JaxBarkConfig(**tb.CONSTANTS)
    gpt = tb.GPT | {"n_embd": 64}
    cfg.semantic_config = JaxBarkArgs(input_vocab_size=384, output_vocab_size=104, **gpt)
    cfg.coarse_config = JaxBarkArgs(input_vocab_size=144, output_vocab_size=144, **gpt)
    cfg.fine_config = JaxBarkArgs(input_vocab_size=20, output_vocab_size=20, n_codes_total=4,
                                  n_codes_given=1, **gpt)
    jm = jax_bark.Bark(cfg)
    jm.semantic_params, jm.coarse_params, jm.fine_params = tt.drawn(
        lambda: jm.init_params(jax.random.PRNGKey(0)), seed=0)
    pm = tb.port_of(jm)
    float_bytes = quant.quantized_bytes(pm)
    jm.quantize_weights_int8(compute_dtype=jnp.float32)
    pm.quantize_weights_int8()
    return jm, pm, float_bytes


def test_bark_quantizes_what_jax_quantizes(bark):
    """All three GPTs' trees carried over equal the port's quantized states;
    the fine model's 64 x 20 heads (1280 elements) stay float in both."""
    jm, pm, float_bytes = bark
    carried = convert.bark_from_jax_params(jm.semantic_params, jm.coarse_params, jm.fine_params)
    for name in ("semantic_model", "coarse_model", "fine_model"):
        assert_same_state(getattr(pm, name).state_dict(), carried[name])
    assert {"lm_head", "core.h.0.attn.c_attn", "core.h.1.attn.c_proj"} <= \
        int8_keys(carried["semantic_model"])
    assert not any(k.startswith("lm_head") for k in int8_keys(carried["fine_model"]))
    no_float_copy(pm, float_bytes)


def test_bark_int8_logits_match_jax(bark):
    jm, pm, _ = bark
    idx = np.random.RandomState(2).randint(0, 384, (2, 256 + 256 + 7))
    want, _ = jm.semantic_model.apply(jm._dq(jm.semantic_params), jnp.asarray(idx),
                                      merge_context=True)
    peak_close(pm.semantic_model(torch.from_numpy(idx), merge_context=True), want, REL,
               "semantic prefill")
    idx = np.random.RandomState(3).randint(0, 17, (1, 50, 4))
    want = jm.fine_model.apply(jm._dq(jm.fine_params), 2, jnp.asarray(idx))
    peak_close(pm.fine_model(2, torch.from_numpy(idx)), want, REL, "fine logits")


def test_bark_int8_stages_tokens_identical(bark):
    """The semantic stage, the coarse stage's windows and the fine stage,
    argmax in both packages."""
    jm, pm, _ = bark
    text = np.frombuffer(TEXT.encode(), np.uint8).astype(np.int64)
    jm._jit_cache.clear()
    with tb.greedy():
        want = jm.generate_text_semantic(text, jax.random.PRNGKey(1), max_gen_duration_s=0.4)
        got = pm.generate_text_semantic(text, None, max_gen_duration_s=0.4)
        np.testing.assert_array_equal(got, want)
        sem = np.random.RandomState(6).randint(0, 100, 60)
        want = jm.generate_coarse(sem, jax.random.PRNGKey(2))
        got = pm.generate_coarse(sem, None)
        np.testing.assert_array_equal(got, want)
    coarse = np.random.RandomState(8).randint(0, 16, (2, 90)).astype(np.int32)
    want = jm.generate_fine(coarse, jax.random.PRNGKey(3), temperature=None)
    got = pm.generate_fine(coarse, None, temperature=None)
    np.testing.assert_array_equal(got, want)
    jm._jit_cache.clear()
