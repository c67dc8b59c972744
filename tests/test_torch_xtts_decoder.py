"""tts_tpu_torch HiFi decoder, HiFiGAN generator and ResNet speaker encoder
against the JAX package, and replay of the golden reference outputs in
``tests/fixtures/fidelity`` through ``tts_tpu.utils.convert`` →
``flax_to_state_dict``, under the thresholds of ``test_fidelity_corpus``
(log-mel distance < 0.5 dB for the waveform, cosine > 0.9999 for the
d-vector)."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import fast_init_model, tiny_xtts_config
from test_fidelity_corpus import _load, _lsd_db

from tts_tpu.models.xtts import Xtts as JaxXtts
from tts_tpu.models.xtts.hifi_decoder import HifiDecoder as JaxHifiDecoder
from tts_tpu_torch.encoder.model import ResNetSpeakerEncoder
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.hifi_decoder import HifiDecoder
from tts_tpu_torch.models.xtts.model import Xtts
from tts_tpu_torch.utils.convert import flax_to_state_dict, xtts_from_jax_params
from tts_tpu_torch.vocoder.models.hifigan_generator import HifiganGenerator


@pytest.fixture(scope="module")
def pair():
    jm = JaxXtts(tiny_xtts_config())
    fast_init_model(jm, jax.random.PRNGKey(0), attrs=("gpt_params", "decoder_params"),
                    scale=0.1)
    tm = Xtts(XttsConfig.from_dict(jm.config.to_dict()))
    tm.load_state_dict_with_stats(xtts_from_jax_params(jm.gpt_params, jm.decoder_params))
    return jm, tm


def test_hifi_decoder_matches_jax(pair):
    """latents → 24 kHz wav through both interpolations and the conditioned
    HiFiGAN; atol 1e-5 on tanh outputs (fp32, sums in another order)."""
    jm, tm = pair
    rs = np.random.RandomState(0)
    latents = rs.randn(2, 6, 64).astype(np.float32)
    spk = rs.randn(2, 512).astype(np.float32)
    want = np.asarray(jm.hifigan_decoder.apply(jm.decoder_params, jnp.asarray(latents),
                                               jnp.asarray(spk)))
    got = tm.hifigan_decoder(torch.from_numpy(latents), torch.from_numpy(spk)).numpy()
    # 6 codes → 24 frames → int(24 · 24000/22050) = 26 frames → × 256 samples
    assert got.shape == want.shape == (2, 26 * 256, 1)
    assert np.abs(want).max() > 1e-3  # not a trivially silent comparison
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("scale", [4.0, 24000 / 22050])
def test_linear_interp_matches_jax(scale):
    x = np.random.RandomState(1).randn(2, 13, 5).astype(np.float32)
    want = np.asarray(JaxHifiDecoder._linear_interp(jnp.asarray(x), scale))
    got = HifiDecoder._linear_interp(torch.from_numpy(x), scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_speaker_encoder_matches_jax(pair):
    jm, tm = pair
    mel = np.abs(np.random.RandomState(2).randn(2, 40, 64)).astype(np.float32) + 0.1
    want = np.asarray(jm.hifigan_decoder.apply(jm.decoder_params, jnp.asarray(mel),
                                               method=jm.hifigan_decoder.embed_speaker))
    got = tm.hifigan_decoder.embed_speaker(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("resblock_type", ["1", "2"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("g_frames", [1, 7])
def test_hifigan_generator_matches_jax(resblock_type, masked, g_frames):
    """Both resblock kinds, per-stage conditioning (one vector, or one per
    input frame that follows the upsampled resolution), and the optional
    x_mask that is re-applied after every conv (masked frames stay 0)."""
    from tts_tpu.vocoder.models.hifigan_generator import HifiganGenerator as JaxGenerator

    kw = dict(in_channels=8, out_channels=1, resblock_type=resblock_type,
              resblock_dilation_sizes=((1, 3, 5), (1, 3)) if resblock_type == "1" else ((1, 3), (1, 2)),
              resblock_kernel_sizes=(3, 5), upsample_kernel_sizes=(4, 4),
              upsample_initial_channel=16, upsample_factors=(2, 2), cond_channels=4,
              cond_in_each_up_layer=True)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 7, 8).astype(np.float32)
    g = rs.randn(2, g_frames, 4).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(7)[None, :, None] < np.array([7, 4])[:, None, None]).astype(np.float32)
    jg = JaxGenerator(inference_padding=0, **kw)
    params = jg.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(g),
                     None if mask is None else jnp.asarray(mask))
    want = np.asarray(jg.apply(params, jnp.asarray(x), jnp.asarray(g),
                               None if mask is None else jnp.asarray(mask)))
    tg = HifiganGenerator(**kw)
    tg.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.from_numpy(g),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 28, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if masked:
        assert np.all(got[1, 16:] == 0)


def test_xtts_hifi_decoder_golden_replay():
    """Reference HiFiGAN (XTTS variant: per-stage speaker conditioning,
    weight norm, no conv_post bias) at fidelity-corpus size."""
    from tts_tpu.utils.convert import convert_hifigan_generator

    state, ins, outs, _ = _load("xtts_hifi_decoder")
    gen = HifiganGenerator(
        in_channels=24, out_channels=1, resblock_type="1",
        resblock_dilation_sizes=((1, 3, 5),), resblock_kernel_sizes=(3,),
        upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
        upsample_factors=(4, 4), cond_channels=16,
        conv_post_bias=False, cond_in_each_up_layer=True,
    )
    gen.load_state_dict(flax_to_state_dict(convert_hifigan_generator(state)), strict=True)
    with torch.no_grad():
        wav = gen(torch.from_numpy(ins["latents"].transpose(0, 2, 1)),
                  torch.from_numpy(ins["spk"][:, :, 0])[:, None, :])
    ref = outs["wav"][0, 0]
    ours = wav.numpy()[0, :, 0]
    assert abs(len(ref) - len(ours)) <= 64
    n = min(len(ref), len(ours))
    lsd = _lsd_db(ref[:n], ours[:n])
    assert lsd < 0.5, f"log-mel-spectral distance {lsd:.4f} dB"


def test_speaker_encoder_golden_replay():
    from tts_tpu.utils.convert import convert_resnet_speaker_encoder

    state, ins, outs, meta = _load("speaker_encoder_resnet")
    enc = ResNetSpeakerEncoder(input_dim=meta["input_dim"], proj_dim=meta["proj_dim"],
                               log_input=True)
    enc.load_state_dict(flax_to_state_dict(convert_resnet_speaker_encoder(state)), strict=True)
    with torch.no_grad():
        ours = enc(torch.from_numpy(ins["mel"].transpose(0, 2, 1)), l2_norm=True).numpy()
    ref = outs["emb"]
    cos = np.sum(ref * ours, axis=-1) / (
        np.linalg.norm(ref, axis=-1) * np.linalg.norm(ours, axis=-1)
    )
    assert np.all(cos > 0.9999), cos
