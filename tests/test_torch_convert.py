"""Reference-layout XTTS checkpoints into the port.

``load_reference_xtts`` reads a ``model.pth`` laid out as the reference
(coqui) XTTS saves it and goes through the JAX package's ``convert_xtts``.
No real checkpoint ships with the repository, so the test writes a synthetic
one at tiny GPT width: every key and shape of the reference layout, values
from a numpy seed (the speaker encoder from the fidelity corpus manifest).
The port loaded from it must agree with the JAX package loaded from the same
file (fp32 atol 1e-4), and a model directory holding only ``model.pth``
must serve.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import synth_state_from_manifest, tiny_xtts_config

from tts_tpu.models.xtts import Xtts as JaxXtts
from tts_tpu.utils.convert import convert_xtts
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
from tts_tpu_torch.utils.convert import load_reference_xtts
from tts_tpu_torch.utils.synthesizer import Synthesizer

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "fidelity", "speaker_encoder_resnet.npz")


def reference_state(args, seed=0):
    """Reference XTTS v2 state dict (``gpt.*``, ``hifigan_decoder.*``,
    ``mel_stats``) for the dims in ``args``."""
    rs = np.random.RandomState(seed)
    s = {}

    def w(name, *shape, scale=0.05, offset=0.0):
        s[name] = (offset + scale * rs.randn(*shape)).astype(np.float32)

    D, L = args.gpt_n_model_channels, args.gpt_layers
    g = "gpt."
    w(g + "conditioning_encoder.init.weight", D, 80, 1)
    w(g + "conditioning_encoder.init.bias", D)
    for i in range(6):
        k = f"{g}conditioning_encoder.attn.{i}"
        w(k + ".norm.weight", D, scale=0.1, offset=1.0)
        w(k + ".norm.bias", D)
        w(k + ".qkv.weight", 3 * D, D, 1)
        w(k + ".qkv.bias", 3 * D)
        w(k + ".proj_out.weight", D, D, 1)
        w(k + ".proj_out.bias", D)
    p = g + "conditioning_perceiver."
    inner, ff = 64 * 8, int(D * 4 * 2 / 3)
    w(p + "latents", 32, D)
    w(p + "norm.gamma", D, scale=0.1, offset=1.0)
    for i in range(2):
        w(f"{p}layers.{i}.0.to_q.weight", inner, D)
        w(f"{p}layers.{i}.0.to_kv.weight", 2 * inner, D)
        w(f"{p}layers.{i}.0.to_out.weight", D, inner)
        w(f"{p}layers.{i}.1.0.weight", 2 * ff, D)
        w(f"{p}layers.{i}.1.0.bias", 2 * ff)
        w(f"{p}layers.{i}.1.2.weight", D, ff)
        w(f"{p}layers.{i}.1.2.bias", D)
    w(g + "text_embedding.weight", args.gpt_number_text_tokens, D)
    w(g + "mel_embedding.weight", args.gpt_num_audio_tokens, D)
    w(g + "text_pos_embedding.emb.weight", args.gpt_max_text_tokens + 2, D)
    w(g + "mel_pos_embedding.emb.weight", args.gpt_max_audio_tokens + 3, D)
    for i in range(L):
        k = f"{g}gpt.h.{i}"
        for ln in ("ln_1", "ln_2"):
            w(f"{k}.{ln}.weight", D, scale=0.1, offset=1.0)
            w(f"{k}.{ln}.bias", D)
        # HF GPT-2 Conv1D weights are [in, out]
        for name, (n_in, n_out) in {"attn.c_attn": (D, 3 * D), "attn.c_proj": (D, D),
                                    "mlp.c_fc": (D, 4 * D), "mlp.c_proj": (4 * D, D)}.items():
            w(f"{k}.{name}.weight", n_in, n_out)
            w(f"{k}.{name}.bias", n_out)
    for ln in ("gpt.ln_f", "final_norm"):
        w(f"{g}{ln}.weight", D, scale=0.1, offset=1.0)
        w(f"{g}{ln}.bias", D)
    for head, n in (("text_head", args.gpt_number_text_tokens), ("mel_head", args.gpt_num_audio_tokens)):
        w(f"{g}{head}.weight", n, D)
        w(f"{g}{head}.bias", n)

    h = "hifigan_decoder.waveform_decoder."
    w(h + "conv_pre.weight", 512, args.decoder_input_dim, 7)
    w(h + "conv_pre.bias", 512)
    w(h + "cond_layer.weight", 512, 512, 1, scale=0.02)
    w(h + "cond_layer.bias", 512)
    ch = 512
    for i, (u, k) in enumerate(zip((8, 8, 2, 2), (16, 16, 4, 4))):
        w(f"{h}ups.{i}.weight", ch, ch // 2, k, scale=0.02)
        w(f"{h}ups.{i}.bias", ch // 2)
        ch //= 2
        w(f"{h}conds.{i}.weight", ch, 512, 1, scale=0.02)
        w(f"{h}conds.{i}.bias", ch)
        for j, rk in enumerate((3, 7, 11)):
            for group in ("convs1", "convs2"):
                for c in range(3):
                    w(f"{h}resblocks.{3 * i + j}.{group}.{c}.weight", ch, ch, rk, scale=0.02)
                    w(f"{h}resblocks.{3 * i + j}.{group}.{c}.bias", ch)
    w(h + "conv_post.weight", 1, ch, 7)

    npz = np.load(FIXTURE)
    meta = json.loads(bytes(npz["meta"]).decode())
    for k, v in synth_state_from_manifest(meta["state_manifest"], meta["state_seed"]).items():
        s["hifigan_decoder.speaker_encoder." + k] = v
    w("mel_stats", 80, scale=0.1, offset=1.0)
    return s


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    config = tiny_xtts_config()
    state = reference_state(config.model_args)
    path = tmp_path_factory.mktemp("ref_ckpt") / "model.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    return config, state, path


def test_reference_checkpoint_matches_jax(checkpoint):
    config, state, path = checkpoint
    args = config.model_args
    port_state = load_reference_xtts(str(path), layers=args.gpt_layers, heads=args.gpt_n_heads)
    np.testing.assert_array_equal(port_state["mel_stats"].numpy(), state["mel_stats"])
    tm = Xtts(XttsConfig.from_dict(config.to_dict()))
    tm.load_state_dict_with_stats(port_state)  # strict: every parameter, nothing extra

    jm = JaxXtts(config)
    jm.gpt_params, jm.decoder_params = convert_xtts(
        {k: v for k, v in state.items() if k != "mel_stats"},
        layers=args.gpt_layers, heads=args.gpt_n_heads,
    )
    rs = np.random.RandomState(1)
    mel = rs.randn(1, 48, 80).astype(np.float32)
    want = jm.gpt.apply(jm.gpt_params, jnp.asarray(mel), method=jm.gpt.get_style_emb)
    got = tm.gpt.get_style_emb(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    latents = rs.randn(1, 4, 64).astype(np.float32)
    spk = rs.randn(1, 512).astype(np.float32)
    want = jm.hifigan_decoder.apply(jm.decoder_params, jnp.asarray(latents), jnp.asarray(spk))
    got = tm.hifigan_decoder(torch.from_numpy(latents), torch.from_numpy(spk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    feats = np.abs(rs.randn(1, 50, 64)).astype(np.float32) + 0.1
    want = jm.hifigan_decoder.apply(jm.decoder_params, jnp.asarray(feats),
                                    method=jm.hifigan_decoder.embed_speaker)
    got = tm.hifigan_decoder.embed_speaker(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_model_dir_with_reference_weights_serves(checkpoint, tmp_path):
    config, _, path = checkpoint
    config.top_k = 1
    (tmp_path / "model.pth").symlink_to(path)
    (tmp_path / "config.json").write_text(json.dumps(config.to_dict(), default=str))
    write_char_vocab(str(tmp_path / "vocab.json"), "abcdefghijklmnopqrstuvwxyz.")
    synth = Synthesizer(model_dir=str(tmp_path), device="cpu")
    assert synth.tts_model.mel_stats is not None
    cond = torch.zeros(1, 32, 64)
    spk = torch.nn.functional.normalize(torch.ones(1, 512), dim=-1)
    chunks = list(synth.tts_model.inference_stream("hi.", "en", cond, spk, max_new_tokens=8,
                                                   stream_chunk_size=4, top_k=1))
    assert chunks and all(np.isfinite(c).all() for c in chunks)
