"""VITS voice conversion in the port against the JAX package, on the CPU: the
coupling flow's forward direction, the posterior encoder's explicit noise,
``Vits.voice_conversion`` with speaker ids and with d-vectors, the
``Synthesizer``'s ``reference_wav`` path and the command line's
``--reference_wav`` / ``--reference_speaker_idx``.

Tiny models (``test_torch_vits_model.tiny_vits_args``, N(0, 0.1²) weights
carried over by ``vits_from_jax_params``); the JAX package's posterior draw
is recorded and replayed into the port. Tolerances: 1e-5 for the flows,
1e-4 for waveforms.

F15, named in its test: the JAX ``Synthesizer`` feeds the posterior
encoder its ``AudioProcessor``'s spectrogram (centred STFT, decibels,
normalised). The reference's voice conversion and the reference-layout
checkpoints' training use the VITS linear magnitude (``wav_to_spec``:
``center=False``, ``(n_fft - hop) / 2`` reflect padding,
``sqrt(|X|² + 1e-6)``), and so does the port. The model-level comparison,
one spectrogram into both packages, is exact either way.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_torch_packed_serving import jax_eager_draws
from test_torch_vits_model import (
    port_of,
    record_jax_normals,
    replay_normals,
    tiny_jax_vits,
)

from tts_tpu.audio import jax_transforms
from tts_tpu.audio.numpy_transforms import save_wav as jax_save_wav
from tts_tpu.audio.processor import AudioProcessor
from tts_tpu.models.vits.config import VitsAudioConfig as JaxVitsAudioConfig
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.audio.torch_transforms import wav_to_spec
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.utils.synthesizer import Synthesizer

ATOL = 1e-5
WAV_ATOL = 1e-4
SPEAKERS = ["p225", "p226", "p227"]
D_VECTOR_DIM = 16
CASES = {
    "speaker_ids": dict(use_speaker_embedding=True, num_speakers=3),
    "d_vectors": dict(use_d_vector_file=True, d_vector_dim=D_VECTOR_DIM),
}
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
# 65 frequency bins, the tiny model's spectrogram width, at its hop of 16
SPECTROGRAM_AUDIO = JaxVitsAudioConfig(fft_size=128, win_length=128, hop_length=16)


def _close(got, want, atol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _spectrogram_batch(seed=0):
    rs = np.random.RandomState(seed)
    y = np.abs(rs.randn(2, 30, 65)).astype(np.float32)
    return y, np.array([30, 22], np.int32)


def _speakers(case, seed=0):
    rs = np.random.RandomState(seed)
    if case == "speaker_ids":
        return np.array([1, 2], np.int32), np.array([2, 0], np.int32)
    return (rs.randn(2, D_VECTOR_DIM).astype(np.float32),
            rs.randn(2, D_VECTOR_DIM).astype(np.float32))


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jm, params = tiny_jax_vits(seed=2, **CASES[request.param])
    return request.param, jm, params, port_of(jm, params)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_flow_matches_jax_and_inverts(pair):
    """The coupling flow's forward (training) direction with a speaker
    vector against the JAX one; the inverse direction undoes it."""
    case, jm, params, port = pair
    rs = np.random.RandomState(1)
    z = rs.randn(2, 40, 32).astype(np.float32)
    mask = (np.arange(40)[None, :] < np.array([40, 27])[:, None]).astype(np.float32)[..., None]
    g = port._speaker_vector(torch.from_numpy(_speakers(case)[0]))
    want = jm.module.apply(params, jnp.asarray(z), jnp.asarray(mask), jnp.asarray(g.numpy()),
                           method=lambda m, z, mask, g: m.flow(z, mask, g=g, reverse=False))
    got = port.module.flow(torch.from_numpy(z), torch.from_numpy(mask), g=g, reverse=False)
    _close(got, want, ATOL, "forward flow")
    back = port.module.flow(got, torch.from_numpy(mask), g=g)
    _close(back, z * mask, ATOL, "inverse of forward")


def test_posterior_encoder_takes_explicit_noise(pair):
    """A given noise tensor is the sample's noise; a generator draws it."""
    _, _, _, port = pair
    y, yl = _spectrogram_batch()
    noise = torch.randn(2, 30, 32, generator=torch.Generator().manual_seed(3))
    given = port.module.posterior_encoder(torch.from_numpy(y), torch.from_numpy(yl), noise=noise)
    drawn = port.module.posterior_encoder(torch.from_numpy(y), torch.from_numpy(yl),
                                          torch.Generator().manual_seed(3))
    for a, b in zip(given, drawn):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_voice_conversion_matches_jax(pair):
    """``Vits.voice_conversion`` against the JAX one on its posterior draw
    (``PRNGKey(0)``, replayed): the waveform within 1e-4."""
    case, jm, params, port = pair
    y, yl = _spectrogram_batch()
    src, tgt = _speakers(case)
    with record_jax_normals() as draws:
        want = jm.voice_conversion(params, y, yl, src, tgt)
    assert [d.shape for d in draws] == [(2, 30, 32)]
    with replay_normals(draws):
        got = port.voice_conversion(torch.from_numpy(y), torch.from_numpy(yl),
                                    torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.shape == (2, 30 * port.hop_length, 1)
    _close(got, want, WAV_ATOL, "converted waveform")
    with replay_normals(draws):
        same = port.voice_conversion(y, yl, src, src)
    assert np.abs(same.numpy() - got.numpy()).max() > 1e-3  # the target speaker matters


def test_voice_conversion_upsamples_the_latent_of_encoder_rate_models():
    """The JAX package's named divergence from the reference, kept: an
    ``encoder_sample_rate`` model's converted latent is upsampled as in
    inference, so the audio has the output rate's length (the reference
    omits the step, ``tests/test_vits_upsampling.py``)."""
    jm, params = tiny_jax_vits(seed=3, encoder_sample_rate=11025, interpolate_z=True,
                               config_kw=dict(audio=JaxVitsAudioConfig(hop_length=16)),
                               **CASES["speaker_ids"])
    port = port_of(jm, params)
    y, yl = _spectrogram_batch(1)
    src, tgt = _speakers("speaker_ids")
    with record_jax_normals() as draws:
        want = jm.voice_conversion(params, y, yl, src, tgt)
    with replay_normals(draws):
        got = port.voice_conversion(y, yl, src, tgt)
    assert got.shape == (2, 30 * 2 * 16, 1) == np.asarray(want).shape
    _close(got, want, WAV_ATOL, "encoder-rate conversion")


def test_voice_conversion_needs_speakers():
    jm, params = tiny_jax_vits(seed=2)
    port = port_of(jm, params)
    y, yl = _spectrogram_batch()
    with pytest.raises(ValueError, match="multi-speaker"):
        port.voice_conversion(y, yl, np.array([0]), np.array([1]))


# ---------------------------------------------------------------------------
# the Synthesizer and the command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny speaker-embedding VITS (speakers on the config's top level,
    where the JAX package reads them) as the JAX ``model.msgpack`` and the
    port's ``model_torch.pt``, with ``speakers.json`` and a reference wav."""
    from tts_tpu.utils.io import save_checkpoint

    d = tmp_path_factory.mktemp("vits_vc")
    with open(d / "speakers.json", "w") as f:
        json.dump({n: i for i, n in enumerate(SPEAKERS)}, f)
    jm, params = tiny_jax_vits(
        seed=4, num_chars=100, config_kw=dict(RECIPE, use_speaker_embedding=True,
                                              num_speakers=3,
                                              speakers_file=str(d / "speakers.json"),
                                              audio=SPECTROGRAM_AUDIO),
        **CASES["speaker_ids"])
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), d / "model_torch.pt")
    rs = np.random.RandomState(0)
    t = np.arange(11025, dtype=np.float32) / 22050.0
    jax_save_wav(wav=0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rs.randn(len(t)),
                 path=str(d / "ref.wav"), sample_rate=22050)
    return d, jm, params


def port_synth(d):
    return Synthesizer(tts_checkpoint=str(d / "model_torch.pt"),
                       tts_config_path=str(d / "config.json"), device="cpu")


def _reference(d):
    from tts_tpu.audio.numpy_transforms import load_wav

    return load_wav(filename=str(d / "ref.wav"), sample_rate=22050, resample=True)


def test_f15_the_audio_processors_spectrogram_is_not_the_vits_spectrogram(model_dir):
    """F15: what the JAX ``Synthesizer`` feeds the posterior encoder
    (``AudioProcessor.spectrogram`` of a ``VitsAudioConfig``) is a centred,
    decibel, normalised spectrogram: one frame more, and other values,
    than the VITS linear magnitude the encoder is trained on. The port's
    ``wav_to_spec`` is the JAX package's ``wav_to_spec``."""
    d, jm, _ = model_dir
    wav = _reference(d)
    audio = jm.config.audio
    ap = AudioProcessor.init_from_config(audio, verbose=False)
    jax_synth_spec = ap.spectrogram(wav)  # [C, T + 1], decibels
    vits_spec = np.asarray(jax_transforms.wav_to_spec(
        jnp.asarray(wav[None]), audio.fft_size, audio.hop_length, audio.win_length))[0]
    ours = wav_to_spec(torch.from_numpy(wav[None]), audio.fft_size, audio.hop_length,
                       audio.win_length)[0].numpy()
    _close(ours, vits_spec, ATOL, "wav_to_spec")
    assert vits_spec.shape[1] == len(wav) // audio.hop_length
    assert jax_synth_spec.shape == (vits_spec.shape[0], vits_spec.shape[1] + 1)
    assert jax_synth_spec.min() < 0 <= vits_spec.min()  # decibels against magnitudes


def test_synthesizer_voice_transfer_follows_the_reference(model_dir):
    """``Synthesizer.tts(reference_wav=...)`` is the JAX package's
    ``Vits.voice_conversion`` on the VITS linear spectrogram (within 1e-4 on
    the same draw); the JAX ``Synthesizer`` feeds the encoder another
    spectrogram and so gives other audio, one hop longer (F15)."""
    d, jm, params = model_dir
    wav = _reference(d)
    a = jm.config.audio
    spec = np.asarray(jax_transforms.wav_to_spec(jnp.asarray(wav[None]), a.fft_size,
                                                 a.hop_length, a.win_length))
    with record_jax_normals() as draws:
        want = np.asarray(jm.voice_conversion(params, spec.transpose(0, 2, 1),
                                              np.array([spec.shape[2]]), np.array([0]),
                                              np.array([2]))).reshape(-1)
    with replay_normals(draws):
        got = np.asarray(port_synth(d).tts(reference_wav=str(d / "ref.wav"), speaker_name="p227",
                                           reference_speaker_name="p225"), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)

    with jax_eager_draws():
        jax_synth = JaxSynthesizer(tts_checkpoint=str(d / "model.msgpack"),
                                   tts_config_path=str(d / "config.json"))
        theirs = np.asarray(jax_synth.tts(reference_wav=str(d / "ref.wav"), speaker_name="p227",
                                          reference_speaker_name="p225"), np.float32)
    assert len(theirs) == len(got) + a.hop_length  # one frame more, 16 samples


@pytest.mark.parametrize("given,error,match", [
    (dict(speaker_name="p227"), ValueError, "both"),
    (dict(reference_speaker_name="p225"), ValueError, "both"),
    (dict(speaker_name="p999", reference_speaker_name="p225"), ValueError, "not in the"),
])
def test_voice_transfer_error_surface(model_dir, given, error, match):
    d, _, _ = model_dir
    with pytest.raises(error, match=match):
        port_synth(d).tts(reference_wav=str(d / "ref.wav"), **given)


def test_cli_reference_wav(model_dir, tmp_path):
    """``tts --reference_wav --reference_speaker_idx --speaker_idx`` writes
    the ``Synthesizer``'s converted audio (within one int16 step)."""
    d, _, _ = model_dir
    out = tmp_path / "vc.wav"
    port_cli(["--model_path", str(d / "model_torch.pt"), "--config_path", str(d / "config.json"),
              "--reference_wav", str(d / "ref.wav"), "--reference_speaker_idx", "p225",
              "--speaker_idx", "p226", "--out_path", str(out), "--device", "cpu"])
    synth = port_synth(d)
    wav = np.asarray(synth.tts(reference_wav=str(d / "ref.wav"), speaker_name="p226",
                               reference_speaker_name="p225"), np.float32)
    expected = tmp_path / "api.wav"
    synth.save_wav(wav, str(expected))
    (sr, got), (_, want) = (scipy.io.wavfile.read(p) for p in (out, expected))
    assert sr == 22050 and got.shape == want.shape == (len(wav),)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
