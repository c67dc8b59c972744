"""The port's speaker encoders (``tts_tpu_torch.encoder``: the SE-ResNet and
the LSTM encoder, the ``SpeakerEncoder`` wrapper, ``load_speaker_encoder``;
``utils.managers.SpeakerManager.compute_embedding_from_clip``; the encoder
converters of ``utils.convert``) against the JAX package's, on the CPU.

The same weights go into both packages: flax parameters drawn from a seed
(``test_torch_glow_tts.drawn_params``), carried into the port by
``utils.convert.speaker_encoder_from_jax_params``. The ResNet is small (one
block a stage, 8 to 16 filters, 16 mels, a 32-wide d-vector) but in the
fixture replay, which runs the published SE-ResNet34 at 64 mels; the LSTM
encoder is 2 layers of 24 at 20 mels. d-vectors agree within 1e-5.

The JAX wrapper builds its ResNet with group norms, which no converted
reference checkpoint fits (``convert_resnet_speaker_encoder`` yields folded
norms); the port's wrapper builds folded norms, so the wrapper comparisons
hand the JAX wrapper a folded ResNet.

Divergence from the JAX package, named in its test (ROADMAP.md F21): a
ResNet with ``log_input`` takes the log of the wrapper's features, which are
already a log-mel, and the JAX wrapper's d-vector is all NaN; the port's
wrapper hands such a module ``exp`` of the log-mel, and equals the JAX
module applied to ``exp`` of the JAX log-mel.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_fidelity_corpus import _load
from test_torch_glow_tts import drawn_params

from tts_tpu.audio import jax_transforms as jt
from tts_tpu.encoder import model as jax_encoder
from tts_tpu.encoder.configs import SpeakerEncoderConfig as JaxSpeakerEncoderConfig
from tts_tpu.utils.io import save_checkpoint
from tts_tpu.utils.managers import SpeakerManager as JaxSpeakerManager
from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig
from tts_tpu_torch.encoder.model import (
    LSTMSpeakerEncoder,
    ResNetSpeakerEncoder,
    SpeakerEncoder,
    load_speaker_encoder,
)
from tts_tpu_torch.utils.convert import (
    load_reference_speaker_encoder,
    reference_speaker_encoder_state,
    speaker_encoder_from_jax_params,
)
from tts_tpu_torch.utils.managers import SpeakerManager

ATOL = 1e-5
SR = 16000
AUDIO = dict(sample_rate=SR, fft_size=512, win_length=400, hop_length=160, num_mels=16)
RESNET = {"model_name": "resnet", "input_dim": 16, "proj_dim": 32}
LSTM = {"model_name": "lstm", "input_dim": 20, "proj_dim": 16, "lstm_dim": 24,
        "num_lstm_layers": 2}
LSTM_AUDIO = dict(sample_rate=SR, fft_size=256, win_length=256, hop_length=64, num_mels=20)
SMALL_RESNET = dict(layers=(1, 1, 1, 1), num_filters=(8, 8, 16, 16))


def encoder_config(cls, model_params, audio):
    config = cls()
    config.model_params = dict(model_params)
    for k, v in audio.items():
        setattr(config.audio, k, v)
    return config


def jax_module(model_params, **resnet):
    mp = dict(model_params)
    if mp.pop("model_name") == "lstm":
        return jax_encoder.LSTMSpeakerEncoder(**mp)
    return jax_encoder.ResNetSpeakerEncoder(norm_type="folded", **mp, **resnet)


def jax_params(module, seed=0, scale=0.2):
    x = jnp.zeros((1, 40, module.input_dim))
    return jax.tree_util.tree_map(np.asarray, drawn_params(module.init, jax.random.PRNGKey(0), x,
                                                           seed=seed, scale=scale))


def pair(model_params, audio, seed=0):
    """(JAX wrapper, its params, the port's wrapper with the same weights),
    each wrapper's ResNet swapped for a small folded one."""
    module = jax_module(model_params, **SMALL_RESNET)
    params = jax_params(module, seed)
    jw = jax_encoder.SpeakerEncoder(encoder_config(JaxSpeakerEncoderConfig, model_params, audio),
                                    params=params)
    jw.module = module
    port = SpeakerEncoder(encoder_config(SpeakerEncoderConfig, model_params, audio))
    port.module = ResNetSpeakerEncoder(module.input_dim, module.proj_dim,
                                       log_input=module.log_input, **SMALL_RESNET)
    port.load_state_dict(speaker_encoder_from_jax_params(params))
    return jw, params, port


def noise(seconds, seed=0, sr=SR):
    return (0.1 * np.random.RandomState(seed).randn(int(seconds * sr))).astype(np.float32)


def _close(got, want, atol=ATOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs diff {err}"


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lstm", "resnet_asp", "resnet_sap"])
def test_module_matches_jax(kind):
    """Each encoder module on two clips of mels: the LSTM encoder (instance
    norm, 2 LSTM-with-projection layers, last frame), the SE-ResNet with
    attentive statistics pooling of mean and deviation (ASP) or of the mean
    alone (SAP)."""
    pooling = kind[-3:].upper()
    if kind == "lstm":
        module = jax_module(LSTM)
    else:
        module = jax_encoder.ResNetSpeakerEncoder(input_dim=16, proj_dim=32, norm_type="folded",
                                                  encoder_type=pooling, **SMALL_RESNET)
    params = jax_params(module, seed=1)
    port = LSTMSpeakerEncoder(20, 16, 24, 2) if kind == "lstm" else \
        ResNetSpeakerEncoder(16, 32, encoder_type=pooling, **SMALL_RESNET)
    port.load_state_dict(speaker_encoder_from_jax_params(params), strict=True)
    x = np.random.RandomState(2).randn(2, 37, module.input_dim).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, module.apply(params, jnp.asarray(x)), ATOL, kind)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the wrapper: features, windows, F21
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_input", [False, True], ids=["log_mel", "f21_log_input"])
@pytest.mark.parametrize("clip", ["short", "three_windows"])
def test_resnet_wrapper_matches_jax(clip, log_input):
    """The ResNet wrapper on a 1 s clip (97 frames): in one pass, and cut
    into windows of 48 frames every 24 (3 windows, batched in one call in
    the port, looped in the JAX package). Without
    ``log_input``: against the JAX wrapper. With it (F21): the JAX
    wrapper's d-vector is NaN, and the port's equals the JAX module applied
    to ``exp`` of the JAX log-mel, window by window, averaged and
    normalised as the JAX wrapper does."""
    mp = dict(RESNET, log_input=log_input)
    jw, params, port = pair(mp, AUDIO, seed=3)
    wav = noise(1.0, seed=4)
    kw = {} if clip == "short" else {"num_frames": 48}
    got = port.compute_embedding_from_wav(wav, **kw)
    if not log_input:
        _close(got, jw.compute_embedding_from_wav(wav, **kw), ATOL, "d-vector")
        return
    assert np.isnan(jw.compute_embedding_from_wav(wav, **kw)).all()
    mel = jnp.exp(jt.wav_to_mel(jnp.asarray(wav)[None], n_fft=512, num_mels=16, sample_rate=SR,
                                hop_length=160, win_length=400))
    mel = jnp.swapaxes(mel, 1, 2)
    T = mel.shape[1]
    if clip == "short":
        assert T <= 250
        want = np.asarray(jw.module.apply(params, mel))[0]
    else:
        offsets = list(range(0, T - 48 + 1, 24))
        assert len(offsets) == 3
        embs = np.concatenate([np.asarray(jw.module.apply(params, mel[:, o: o + 48]))
                               for o in offsets])
        want = embs.mean(0) / np.linalg.norm(embs.mean(0))
    assert np.isfinite(got).all()
    _close(got, want, ATOL, "F21 d-vector")


def test_speaker_encoder_fixture_replay_through_the_ports_loader():
    """``speaker_encoder_resnet.npz`` (a reference-layout SE-ResNet34, 64
    mels, 512 wide) through ``load_reference_speaker_encoder`` into the
    port's wrapper: cosine to the reference's d-vectors above
    ``test_fidelity_corpus``'s 0.9999 (the JAX module on the same fixture:
    ``test_torch_xtts_decoder.py::test_speaker_encoder_golden_replay``)."""
    state, ins, outs, meta = _load("speaker_encoder_resnet")
    mp = {"model_name": "resnet", "input_dim": meta["input_dim"], "proj_dim": meta["proj_dim"],
          "log_input": True}
    config = encoder_config(SpeakerEncoderConfig, mp, {})
    port = SpeakerEncoder(config).load_state_dict(load_reference_speaker_encoder(state, config))
    mel = ins["mel"].transpose(0, 2, 1)
    with torch.no_grad():
        ours = port.module(torch.from_numpy(mel)).numpy()
    ref = outs["emb"]
    cos = np.sum(ref * ours, axis=-1) / (np.linalg.norm(ref, axis=-1)
                                         * np.linalg.norm(ours, axis=-1))
    assert np.all(cos > 0.9999), cos


# ---------------------------------------------------------------------------
# weights and files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["resnet", "lstm"])
def test_reference_layout_round_trip(kind):
    """``reference_speaker_encoder_state`` writes the reference's names and
    shapes (for the ResNet, those of ``speaker_encoder_resnet.npz`` at its
    widths: BatchNorms with running statistics, ``se.fc.0``, ``attention.3``,
    kernels over (mel, time)), and ``load_reference_speaker_encoder`` reads
    them back to the same tensors."""
    if kind == "resnet":
        _, _, _, meta = _load("speaker_encoder_resnet")
        mp = {"model_name": "resnet", "input_dim": 64, "proj_dim": 512}
        config = encoder_config(SpeakerEncoderConfig, mp, {})
        state = SpeakerEncoder(config).init_params(seed=0, device="cpu").module.state_dict()
        ref = reference_speaker_encoder_state(state)
        manifest = meta["state_manifest"]
        assert set(ref) == set(manifest)
        for k, v in ref.items():
            assert list(v.shape) == manifest[k][0], k
    else:
        config = encoder_config(SpeakerEncoderConfig, LSTM, LSTM_AUDIO)
        state = SpeakerEncoder(config).init_params(seed=0, device="cpu").module.state_dict()
        ref = reference_speaker_encoder_state(state)
        assert set(ref) == {f"layers.{i}.{leaf}" for i in range(2) for leaf in (
            "lstm.weight_ih_l0", "lstm.weight_hh_l0", "lstm.bias_ih_l0", "lstm.bias_hh_l0",
            "linear.weight")}
    back = load_reference_speaker_encoder(ref, config)
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


@pytest.mark.parametrize("kind", ["resnet", "lstm"])
def test_weights_carry_over_strictly(kind):
    """Every JAX leaf lands in the port's module and every tensor of the
    port's module comes from one (the LSTM's input-side bias as zeros, its
    one bias a gate on the hidden side)."""
    mp = RESNET if kind == "resnet" else LSTM
    params = jax_params(jax_module(mp), seed=5)
    carried = speaker_encoder_from_jax_params(params)
    port = SpeakerEncoder(encoder_config(SpeakerEncoderConfig, mp, AUDIO))
    assert set(carried) == set(port.module.state_dict())
    n_jax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    n_bias_ih = sum(v.numel() for k, v in carried.items() if "bias_ih" in k)
    assert sum(v.numel() for v in carried.values()) == n_jax + n_bias_ih
    assert all(not v.any() for k, v in carried.items() if "bias_ih" in k)


def test_compute_embedding_from_clip_resamples_to_the_encoders_rate(tmp_path):
    """``SpeakerManager.compute_embedding_from_clip`` on 22.05 kHz wav
    files, the LSTM encoder at 16 kHz: the port's manager, loading the
    reference-layout ``model_se.pth.tar`` and its config through
    ``load_speaker_encoder``, against the JAX manager loading its own
    checkpoint of the same weights; one clip, and the mean over two."""
    module = jax_module(LSTM)
    params = jax_params(module, seed=6)
    jax_cfg = encoder_config(JaxSpeakerEncoderConfig, LSTM, LSTM_AUDIO)
    save_checkpoint(str(tmp_path / "encoder.msgpack"), params, config=jax_cfg)
    (tmp_path / "jax_config.json").write_text(json.dumps(jax_cfg.to_dict(), default=str))
    port_cfg = encoder_config(SpeakerEncoderConfig, LSTM, LSTM_AUDIO)
    state = reference_speaker_encoder_state(speaker_encoder_from_jax_params(params))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "model_se.pth.tar")
    (tmp_path / "config_se.json").write_text(json.dumps(port_cfg.to_dict()))
    clips = []
    for i in range(2):
        path = tmp_path / f"clip{i}.wav"
        scipy.io.wavfile.write(path, 22050, (noise(0.8, seed=7 + i, sr=22050) * 32767
                                             ).astype(np.int16))
        clips.append(str(path))

    jm = JaxSpeakerManager()
    jm.init_encoder(str(tmp_path / "encoder.msgpack"), str(tmp_path / "jax_config.json"))
    pm = SpeakerManager()
    pm.init_encoder(str(tmp_path / "model_se.pth.tar"), str(tmp_path / "config_se.json"),
                    device="cpu")
    assert pm.encoder_ap.sample_rate == SR
    for wavs in (clips[0], clips):
        _close(pm.compute_embedding_from_clip(wavs), jm.compute_embedding_from_clip(wavs), ATOL,
               f"{len(wavs) if isinstance(wavs, list) else 1} clip(s)")
    encoder, ap = load_speaker_encoder(str(tmp_path / "model_se.pth.tar"),
                                       str(tmp_path / "config_se.json"), device="cpu")
    with pytest.raises(ValueError, match="config.json"):
        load_speaker_encoder(str(tmp_path / "model_se.pth.tar"), "", device="cpu")
