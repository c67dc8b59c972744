"""Bark's voice-prompt front end and Tortoise's wav2vec alignment in
tts_tpu_torch against the JAX package on the CPU, at small sizes: HuBERT (an
HF ``HubertModel`` of 3 layers 96 wide with a 3-conv extractor, random
weights), the LSTM tokenizer (versions 0 and 1), EnCodec's encoder with
``rvq_encode`` (``test_torch_bark``'s small EnCodec), ``Bark.generate_voice``
and wav2vec2-CTC (an HF ``Wav2Vec2ForCTC`` of the same size, pre-LN with a
layer-norm extractor) with the aligner.

Both packages read the same reference state dicts through their own
converters. Tolerances (fp32): features, logits and latents within 1e-4 of
their peak; token ids, codes and alignments exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bark import encodec_state, jax_tiny, port_of
from test_torch_tortoise import peak_close

from tts_tpu.models.bark import hubert as jax_hubert
from tts_tpu.models.tortoise import wav2vec_alignment as jax_w2v
from tts_tpu.vc.modules.wavlm import WavLM as JaxWavLM
from tts_tpu.vc.modules.wavlm import WavLMConfig as JaxWavLMConfig
from tts_tpu_torch.models.bark import encodec, hubert
from tts_tpu_torch.models.tortoise import wav2vec_alignment as w2v
from tts_tpu_torch.vc.modules.wavlm import WavLMConfig

transformers = pytest.importorskip("transformers")

SMALL = dict(hidden_size=96, num_hidden_layers=3, num_attention_heads=4, intermediate_size=192,
             conv_dim=(48, 48, 48), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, feat_proj_dropout=0.0,
             hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0,
             layer_norm_eps=1e-5, feat_extract_activation="gelu", hidden_act="gelu")


def wavlm_fields(cfg, layer_norm: bool):
    """The HF config's dims as WavLM config fields (HuBERT: group norm,
    post-LN; wav2vec2-large-robust: layer norms, pre-LN)."""
    return dict(extractor_mode="layer_norm" if layer_norm else "default",
                encoder_layers=cfg.num_hidden_layers, encoder_embed_dim=cfg.hidden_size,
                encoder_ffn_embed_dim=cfg.intermediate_size,
                encoder_attention_heads=cfg.num_attention_heads, layer_norm_first=layer_norm,
                conv_feature_layers=tuple(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)),
                conv_bias=cfg.conv_bias, conv_pos=cfg.num_conv_pos_embeddings,
                conv_pos_groups=cfg.num_conv_pos_embedding_groups,
                relative_position_embedding=False, gru_rel_pos=False)


@pytest.fixture(scope="module")
def hf_hubert():
    torch.manual_seed(0)
    cfg = transformers.HubertConfig(do_stable_layer_norm=False, feat_extract_norm="group",
                                    **SMALL)
    state = {k: v.numpy() for k, v in transformers.HubertModel(cfg).eval().state_dict().items()}
    return state, wavlm_fields(cfg, layer_norm=False)


def tokenizer_state(version: int, seed: int = 2):
    """A reference ``HubertTokenizer``'s random state dict: 96 features in,
    32 wide, 50 tokens out (version 1: the 4096-wide layer between)."""
    torch.manual_seed(seed)
    lstm = torch.nn.LSTM(96, 32, 2, batch_first=True)
    state = {f"lstm.{k}": v.detach().numpy() for k, v in lstm.state_dict().items()}
    width = 32
    if version == 1:
        inter = torch.nn.Linear(32, 4096)
        state.update({f"intermediate.{k}": v.detach().numpy()
                      for k, v in inter.state_dict().items()})
        width = 4096
    fc = torch.nn.Linear(width, 50)
    state.update({f"fc.{k}": v.detach().numpy() for k, v in fc.state_dict().items()})
    return state


def jax_tokenizer(state):
    params = jax_hubert.convert_hubert_tokenizer(state)
    tok = jax_hubert.HubertTokenizer(hidden_size=32, input_size=96, output_size=50,
                                     version=1 if "intermediate.weight" in state else 0)
    return tok, params


def test_hubert_features_match_jax(hf_hubert):
    """HuBERT's layer-2 and last-layer features, the JAX WavLM on
    ``convert_hf_hubert``'s params against the port's ``load_hubert``."""
    state, fields = hf_hubert
    jm = JaxWavLM(JaxWavLMConfig(**fields))
    params = jax_hubert.convert_hf_hubert(state)
    pm = hubert.load_hubert(state, WavLMConfig(**fields), device="cpu")
    wav = np.random.RandomState(1).randn(1, 1600).astype(np.float32) * 0.1
    for layer in (2, None):
        want = jm.apply(params, jnp.asarray(wav), output_layer=layer)
        with torch.no_grad():
            peak_close(pm(torch.from_numpy(wav), output_layer=layer), want, 1e-4, f"layer {layer}")
    assert dataclasses.asdict(hubert.hubert_base_config()) == dataclasses.asdict(
        jax_hubert.hubert_base_config())


def test_converters_match_jax(hf_hubert, hf_wav2vec2):
    """The port's copies of ``convert_hf_hubert``, ``convert_hubert_tokenizer``
    (both versions) and ``convert_hf_wav2vec2_ctc`` against the JAX ones,
    leaf for leaf."""
    from test_torch_tortoise import _leaves

    pairs = [(hubert.convert_hf_hubert(hf_hubert[0]), jax_hubert.convert_hf_hubert(hf_hubert[0])),
             (w2v.convert_hf_wav2vec2_ctc(hf_wav2vec2[0]),
              jax_w2v.convert_hf_wav2vec2_ctc(hf_wav2vec2[0]))]
    pairs += [(hubert.convert_hubert_tokenizer(tokenizer_state(v)),
               jax_hubert.convert_hubert_tokenizer(tokenizer_state(v))) for v in (0, 1)]
    for ours, theirs in pairs:
        a, b = dict(_leaves(ours)), dict(_leaves(theirs))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("version", [0, 1])
def test_tokenizer_logits_and_ids_match_jax(version):
    state = tokenizer_state(version)
    tok, params = jax_tokenizer(state)
    pm = hubert.load_hubert_tokenizer(state, device="cpu")
    x = np.random.RandomState(3).randn(2, 9, 96).astype(np.float32)
    with torch.no_grad():
        peak_close(pm(torch.from_numpy(x)), tok.apply(params, jnp.asarray(x)), 1e-4, "logits")
        np.testing.assert_array_equal(pm.get_token(torch.from_numpy(x)).numpy(),
                                      tok.apply(params, jnp.asarray(x), method=tok.get_token))


def test_semantic_tokens_from_audio_match_jax(hf_hubert, monkeypatch):
    state, fields = hf_hubert
    monkeypatch.setattr(jax_hubert, "hubert_base_config", lambda: JaxWavLMConfig(**fields))
    tstate = tokenizer_state(0)
    wav = np.random.RandomState(4).randn(4000).astype(np.float32) * 0.1
    want = jax_hubert.semantic_tokens_from_audio(wav, jax_hubert.convert_hf_hubert(state),
                                                 jax_hubert.convert_hubert_tokenizer(tstate))
    got = hubert.semantic_tokens_from_audio(
        wav, hubert.load_hubert(state, WavLMConfig(**fields), device="cpu"),
        hubert.load_hubert_tokenizer(tstate, device="cpu"))
    assert got.shape == want.shape == (199,)  # 20x downsampling
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jm = jax_tiny(tmp_path=tmp_path_factory.mktemp("bark_voice"))
    return jm, port_of(jm)


def test_encodec_encoder_and_rvq_encode_match_jax(pair):
    """wav → latents (within 1e-4 of their peak) → codes (exact), the JAX
    ``EncodecVocoder.encode`` against the port's."""
    jm, pm = pair
    assert pm.encodec.can_encode
    wav = np.random.RandomState(5).randn(96).astype(np.float32) * 0.3
    voc = jm.encodec_vocoder
    want = voc.encoder.apply(voc.encoder_params, jnp.asarray(wav.reshape(1, -1, 1)))
    with torch.no_grad():
        got = pm.encodec.encoder(torch.from_numpy(wav).reshape(1, 1, -1))
    peak_close(got[0].T, np.asarray(want)[0], 1e-4, "encoder latents")
    np.testing.assert_array_equal(pm.encodec.encode(wav, n_q=4).numpy(), voc.encode(wav, n_q=4))
    lat = got
    codes = encodec.rvq_encode(lat, pm.encodec.codebooks)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jax_encodec_rvq(lat, voc.codebooks)))


def jax_encodec_rvq(lat, codebooks):
    from tts_tpu.models.bark.encodec import rvq_encode

    return rvq_encode(jnp.asarray(lat.numpy().transpose(0, 2, 1)), codebooks)


def test_generate_voice_matches_jax(pair, hf_hubert, monkeypatch, tmp_path):
    """A 24 kHz clip → the voice prompt (HuBERT's semantic tokens at 16 kHz,
    EnCodec's codes at 24 kHz), saved as an ``.npz``: equal to the JAX
    package's."""
    jm, pm = pair
    state, fields = hf_hubert
    monkeypatch.setattr(jax_hubert, "hubert_base_config", lambda: JaxWavLMConfig(**fields))
    tstate = tokenizer_state(0)
    t = np.arange(7200) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    want = jm.generate_voice(wav, jax_hubert.convert_hf_hubert(state),
                             jax_hubert.convert_hubert_tokenizer(tstate), sample_rate=24000)
    got = pm.generate_voice(wav, hubert.load_hubert(state, WavLMConfig(**fields), device="cpu"),
                            hubert.load_hubert_tokenizer(tstate, device="cpu"),
                            output_path=str(tmp_path / "voice.npz"), sample_rate=24000)
    assert sorted(got) == sorted(want) == ["coarse_prompt", "fine_prompt", "semantic_prompt"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with np.load(tmp_path / "voice.npz") as saved:
        assert sorted(saved.files) == sorted(want)
    assert got["fine_prompt"].shape == (8, 7200 // 8)


# ---------------------------------------------------------------------------
# Tortoise's wav2vec alignment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_wav2vec2():
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2Config(vocab_size=40, conv_bias=True, do_stable_layer_norm=True,
                                      feat_extract_norm="layer", final_dropout=0.0, **SMALL)
    state = {k: v.numpy() for k, v in
             transformers.Wav2Vec2ForCTC(cfg).eval().state_dict().items()}
    return state, wavlm_fields(cfg, layer_norm=True)


def test_wav2vec2_ctc_logits_match_jax(hf_wav2vec2):
    state, fields = hf_wav2vec2
    jm = jax_w2v.Wav2Vec2CTC(JaxWavLMConfig(**fields), vocab_size=40)
    params = jax_w2v.convert_hf_wav2vec2_ctc(state)
    pm = w2v.load_wav2vec2_ctc(state, WavLMConfig(**fields), device="cpu")
    wav = np.random.RandomState(1).randn(1, 1600).astype(np.float32) * 0.1
    with torch.no_grad():
        peak_close(pm(torch.from_numpy(wav)), jm.apply(params, jnp.asarray(wav)), 1e-4, "ctc")
    assert dataclasses.asdict(w2v.wav2vec2_large_robust_config()) == dataclasses.asdict(
        jax_w2v.wav2vec2_large_robust_config())


VOCAB = {"~": 0, **{c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz", start=1)}}
BARE = "keep this cut this and keep that"


def spelled_logits():
    """Frames that spell ``BARE``: each character twice, a pad frame after
    each, seven pad frames at the end."""
    ids = []
    for ch in BARE:
        ids += [VOCAB[ch], VOCAB[ch], 0]
    ids += [0] * 7
    logits = np.zeros((len(ids), len(VOCAB)), np.float32)
    logits[np.arange(len(ids)), ids] = 5.0
    return logits


@pytest.mark.parametrize("s1,s2", [("hello world", "helo wrld"), ("abc", "xyz"),
                                   ("keep this", "keep that this"), ("", "abc")])
def test_max_alignment_matches_jax(s1, s2):
    assert w2v.max_alignment(s1, s2) == jax_w2v.max_alignment(s1, s2)


def test_align_and_redact_match_jax():
    """On logits that spell the text: the same character offsets and the
    same redacted audio; text without brackets comes back untouched."""
    logits = spelled_logits()
    audio = np.random.RandomState(0).randn(len(logits) * 160).astype(np.float32)
    ours = w2v.Wav2VecAlignment(lambda wav: logits, VOCAB)
    theirs = jax_w2v.Wav2VecAlignment(lambda wav: logits, VOCAB)
    assert ours.align(audio, BARE, 16000) == theirs.align(audio, BARE, 16000)
    text = "keep this [cut this] and keep that"
    got = ours.redact(audio, text, 16000)
    np.testing.assert_array_equal(got, theirs.redact(audio, text, 16000))
    assert len(audio) // 2 < len(got) < len(audio)
    assert ours.redact(audio, BARE, 16000) is audio


def test_alignment_through_the_model_matches_jax(hf_wav2vec2):
    """The aligner on the loaded CTC model (24 kHz audio resampled to 16
    kHz and normalised): the same frame ids and offsets as the JAX aligner
    on its model."""
    state, fields = hf_wav2vec2
    jm = jax_w2v.Wav2Vec2CTC(JaxWavLMConfig(**fields), vocab_size=40)
    params = jax_w2v.convert_hf_wav2vec2_ctc(state)
    pm = w2v.load_wav2vec2_ctc(state, WavLMConfig(**fields), device="cpu")
    vocab = {c: i for i, c in enumerate("~abcdefghijklmnopqrstuvwxyz .,!?'-", start=0)}
    audio = np.random.RandomState(2).randn(4800).astype(np.float32) * 0.2
    ours = w2v.Wav2VecAlignment(pm, vocab)
    theirs = jax_w2v.Wav2VecAlignment(jax.jit(lambda w: jm.apply(params, w)), vocab)
    np.testing.assert_array_equal(ours._ctc_frame_ids(audio, 24000),
                                  theirs._ctc_frame_ids(audio, 24000))
    heard = ours._decode(ours._ctc_frame_ids(audio, 24000).tolist())
    text = "".join(c for c in heard if c in vocab)[:6] or "a"
    try:
        want = theirs.align(audio, text, 24000)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="alignment failed"):
            ours.align(audio, text, 24000)
    else:
        assert ours.align(audio, text, 24000) == want
