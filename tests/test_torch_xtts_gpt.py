"""tts_tpu_torch XTTS GPT against the JAX package's (``tts_tpu.models.xtts.gpt``).

Both load the same weights: the JAX params of a tiny XTTS
(``helpers.tiny_xtts_config``: 2 layers, 64 wide) carried into the port by
``xtts_from_jax_params``. Inputs come from numpy seeds. Activations agree
within fp32 atol 1e-4 (float32 sums in another order through 2 layers);
greedy decoding (top_k=1) must give identical tokens.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_init_model, tiny_xtts_config

from tts_tpu.models.xtts import Xtts as JaxXtts
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.gpt_core import sample_logits
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.utils.convert import xtts_from_jax_params

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = JaxXtts(tiny_xtts_config())
    fast_init_model(jm, jax.random.PRNGKey(0), attrs=("gpt_params", "decoder_params"))
    tm = Xtts(XttsConfig.from_dict(jm.config.to_dict()))
    tm.load_state_dict_with_stats(xtts_from_jax_params(jm.gpt_params, jm.decoder_params))
    return jm, tm


def _j(jm, *args, method=None, **kw):
    return jm.gpt.apply(jm.gpt_params, *args, method=method, **kw)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.detach().float().numpy(), atol=atol)


def test_state_dict_covers_every_parameter(pair):
    jm, tm = pair
    state = xtts_from_jax_params(jm.gpt_params, jm.decoder_params)
    assert set(state) == set(tm.state_dict())


def test_style_emb(pair):
    jm, tm = pair
    mel = np.random.RandomState(2).randn(2, 64, 80).astype(np.float32)
    want = _j(jm, jnp.asarray(mel), method=jm.gpt.get_style_emb)
    got = tm.gpt.get_style_emb(torch.from_numpy(mel))
    assert got.shape == (2, 32, 64)
    _close(want, got)


def test_teacher_forced_forward(pair):
    jm, tm = pair
    rs = np.random.RandomState(0)
    text = rs.randint(1, 48, (2, 10))
    codes = rs.randint(0, 32, (2, 16))
    mel = rs.randn(2, 64, 80).astype(np.float32)
    want = _j(jm, jnp.asarray(text), jnp.asarray([10, 7]), jnp.asarray(codes),
              jnp.asarray([16, 12]), cond_mels=jnp.asarray(mel))
    with torch.no_grad():
        got = tm.gpt(torch.from_numpy(text), torch.tensor([10, 7]), torch.from_numpy(codes),
                     torch.tensor([16, 12]), cond_mels=torch.from_numpy(mel))
    for key in ("text_logits", "mel_logits", "latents"):
        _close(want[key], got[key])
    for key in ("text_targets", "mel_targets"):
        np.testing.assert_array_equal(np.asarray(want[key]), got[key].numpy())


def _prefill_inputs():
    rs = np.random.RandomState(5)
    cond = rs.randn(2, 8, 64).astype(np.float32)
    text = rs.randint(1, 48, (2, 9))
    return cond, text, np.array([9, 5])  # ragged: row 1 pads with stop tokens


def test_prefill_and_decode_chunk(pair):
    jm, tm = pair
    cond, text, lengths = _prefill_inputs()
    j_state = _j(jm, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
                 max_new_tokens=12, method=jm.gpt.prefill)
    t_state = tm.gpt.prefill(torch.from_numpy(cond), torch.from_numpy(text),
                             torch.from_numpy(lengths), max_new_tokens=12)
    _close(j_state["last_logits"], t_state["last_logits"])
    _close(j_state["last_h"], t_state["last_h"])
    assert t_state["cur_index"] == int(j_state["cur_index"])
    for i in range(2):  # the prefix keys/values written into the cache
        _close(j_state["caches"][i]["k"], t_state["cache"].k[i])

    cache_ptr = t_state["cache"].k[0].data_ptr()
    kw = dict(chunk_size=6, temperature=0.7, top_k=1, top_p=1.0, repetition_penalty=5.0)
    for _ in range(2):  # two chunks: the second continues from the first's state
        j_state, j_toks, j_lats = _j(jm, j_state, jax.random.PRNGKey(1),
                                     method=jm.gpt.decode_chunk, **kw)
        t_state, t_toks, t_lats = tm.gpt.decode_chunk(t_state, None, **kw)
        np.testing.assert_array_equal(np.asarray(j_toks), t_toks.numpy())
        _close(j_lats, t_lats)
        np.testing.assert_array_equal(np.asarray(j_state["out_len"]), t_state["out_len"].numpy())
        np.testing.assert_array_equal(np.asarray(j_state["rep_counts"]),
                                      t_state["rep_counts"].numpy())
    # the port's cache is preallocated and written in place
    assert t_state["cache"].k[0].data_ptr() == cache_ptr
    _close(j_state["caches"][1]["v"], t_state["cache"].v[1])


def test_greedy_generate_token_identical(pair):
    jm, tm = pair
    cond, text, lengths = _prefill_inputs()
    kw = dict(max_new_tokens=16, temperature=0.75, top_k=1, top_p=0.85, repetition_penalty=5.0)
    want = _j(jm, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
              jax.random.PRNGKey(3), method=jm.gpt.generate, **kw)
    steps = tm.gpt.decode_steps
    got = tm.gpt.generate(torch.from_numpy(cond), torch.from_numpy(text),
                          torch.from_numpy(lengths), None, **kw)
    assert tm.gpt.decode_steps == steps + 16
    np.testing.assert_array_equal(np.asarray(want["codes"]), got["codes"].numpy())
    np.testing.assert_array_equal(np.asarray(want["code_lengths"]), got["code_lengths"].numpy())
    _close(want["latents"], got["latents"])


def test_step_counters_exact_under_concurrent_decodes(pair):
    """Serving decodes in several threads at once (the stream batcher's worker
    beside /api/tts); the shared step and token counters lose no update."""
    _, tm = pair
    cond, text, lengths = (torch.from_numpy(a) for a in _prefill_inputs())
    n_threads, n_steps = 8, 25
    steps, tokens = tm.gpt.decode_steps, tm.gpt.decode_tokens
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=tm.gpt.generate, args=(cond, text, lengths, None),
                             kwargs=dict(max_new_tokens=n_steps, top_k=1))
            for _ in range(n_threads)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert tm.gpt.decode_steps == steps + n_threads * n_steps
    assert tm.gpt.decode_tokens == tokens + n_threads * n_steps * cond.shape[0]


def test_decode_step_uses_decode_attention(pair, monkeypatch):
    """Each decode step of each layer goes through ops.decode_attention."""
    from tts_tpu_torch.models.xtts import gpt_core

    calls = []
    real = gpt_core.decode_attention

    def spy(q, k, v, cache_len):
        calls.append(cache_len)
        return real(q, k, v, cache_len)

    monkeypatch.setattr(gpt_core, "decode_attention", spy)
    _, tm = pair
    cond, text, lengths = _prefill_inputs()
    state = tm.gpt.prefill(torch.from_numpy(cond), torch.from_numpy(text),
                           torch.from_numpy(lengths), max_new_tokens=4)
    start = state["cur_index"]
    tm.gpt.decode_chunk(state, None, chunk_size=4, top_k=1)
    n_layers = len(tm.gpt.gpt.h)
    assert calls == [start + 1 + s for s in range(4) for _ in range(n_layers)]


def test_sampling_respects_topk():
    logits = torch.tensor([[0.0, 10.0, 9.0, -5.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    samples = {
        int(sample_logits(logits, gen, temperature=1.0, top_k=2, top_p=1.0)[0])
        for _ in range(40)
    }
    assert samples == {1, 2}


def test_repetition_penalty_discourages_repeats():
    logits = torch.full((1, 4), 2.0)
    counts = torch.tensor([[5, 0, 0, 0]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    hits = sum(
        int(sample_logits(logits, gen, temperature=1.0, top_k=0, top_p=1.0,
                          repetition_counts=counts, repetition_penalty=5.0)[0]) == 0
        for _ in range(50)
    )
    assert hits <= 5  # token 0 heavily penalized


def test_nucleus_keeps_top_token():
    """top_p so small that only the most likely token survives."""
    logits = torch.tensor([[1.0, 3.0, 2.0, 0.5]])
    gen = torch.Generator().manual_seed(1)
    for top_k in (0, 3):
        toks = {int(sample_logits(logits, gen, temperature=1.0, top_k=top_k, top_p=0.01)[0])
                for _ in range(20)}
        assert toks == {1}


def test_decode_stops_at_the_position_table(pair):
    """ROADMAP.md F5: a decode of ``max_mel_tokens - 3`` tokens, the bound
    of every decode of the port, reads its last mel position inside the
    table; one position more raises where the JAX package's
    ``dynamic_slice`` would clamp to the last row."""
    _, tm = pair
    gpt = tm.gpt
    rows = gpt.mel_pos_embedding.shape[0]
    assert rows == gpt.max_mel_tokens + 3
    cond, text, lengths = _prefill_inputs()
    max_new = gpt.max_mel_tokens - 3
    out = gpt.generate(torch.from_numpy(cond), torch.from_numpy(text),
                       torch.from_numpy(lengths), None, max_new_tokens=max_new, top_k=1)
    assert out["codes"].shape == (2, max_new)
    torch.testing.assert_close(gpt._mel_pos(rows - 1, 1), gpt.mel_pos_embedding[rows - 1:])
    with pytest.raises(ValueError, match="position table"):
        gpt._mel_pos(rows - 1, 2)
    with pytest.raises(ValueError, match="position table"):
        gpt._mel_pos(rows, 1)
