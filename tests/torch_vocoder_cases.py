"""What the port's vocoder-training tests share: flax params drawn at unit
gain, the tiny GAN configs of both packages, a batch, and a corpus of wavs
on disk.

``fan_in_params`` draws every kernel N(0, 1 / fan_in) and every bias
N(0, 0.1²) (flax's init leaves biases at 0, and a zero leaf checks
nothing), so activations keep their scale through the discriminators'
stacks and the generators' upsampling.

The tiny audio: 22.05 kHz, FFT 256, hop 64, 16 mels; each generator
upsamples by 64 (HiFiGAN and MelGAN [8, 8], multi-band MelGAN [4, 4] into
4 bands). The STFT losses run at smaller resolutions than the configs'
defaults, so a 2048-sample segment can take every window.
"""

import os

import jax
import numpy as np
import scipy.io.wavfile

AUDIO = dict(sample_rate=22050, fft_size=256, win_length=256, hop_length=64, num_mels=16,
             mel_fmin=0.0, mel_fmax=None)
SEQ_LEN = 2048
STFT = {"n_ffts": [256, 512, 128], "hop_lengths": [32, 64, 16], "win_lengths": [128, 256, 64]}
SUBBAND_STFT = {"n_ffts": [128, 256, 64], "hop_lengths": [16, 32, 8],
                "win_lengths": [64, 128, 32]}

# family → (config class name, generator params, discriminator params, extra fields)
GAN_CASES = {
    "hifigan": ("HifiganConfig",
                dict(upsample_factors=[8, 8], upsample_kernel_sizes=[16, 16],
                     upsample_initial_channel=32, resblock_kernel_sizes=[3, 5],
                     resblock_dilation_sizes=[[1, 3], [1, 3]], resblock_type="1"),
                dict(width_mult=1 / 64), {}),
    "melgan": ("MelganConfig", dict(upsample_factors=[8, 8], base_channels=32, num_res_blocks=2),
               dict(base_channels=4, max_channels=32, downsample_factors=[4, 4]),
               dict(stft_loss_params=STFT)),
    "multiband_melgan": ("MultibandMelganConfig",
                         dict(upsample_factors=[4, 4], base_channels=32, num_res_blocks=2),
                         dict(base_channels=4, max_channels=32, downsample_factors=[4, 4]),
                         dict(stft_loss_params=STFT, subband_stft_loss_params=SUBBAND_STFT,
                              steps_to_start_discriminator=2)),
}


def fan_in_params(init_fn, *args, seed=0, bias=0.1, scale=1.0, **kwargs):
    """Numpy params of ``init_fn``'s structure (traced, never run): kernels
    ``scale`` x N(0, 1 / fan_in) (fan_in: every axis but the last), other
    leaves N(0, bias²), norm scales 1 + N(0, bias²)."""
    shapes = jax.eval_shape(init_fn, *args, **kwargs)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        draw = rs.standard_normal(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1])) or 1
            return (draw * scale / np.sqrt(fan_in)).astype(leaf.dtype)
        draw = (draw * bias).astype(leaf.dtype)
        return draw + 1 if name == "scale" else draw

    return jax.tree_util.tree_map_with_path(fill, shapes)


def gan_configs(family: str, **over):
    """``(JAX config, port config)`` of ``family``'s tiny case (B=2 in the
    tests), ``over`` set on both."""
    from tts_tpu.vocoder import configs as jax_configs
    from tts_tpu_torch.vocoder import configs as port_configs

    name, gen, disc, extra = GAN_CASES[family]
    out = []
    for mod in (jax_configs, port_configs):
        kw = dict(seq_len=SEQ_LEN, pad_short=0, generator_model_params=dict(gen),
                  discriminator_model_params=dict(disc), batch_size=2, eval_batch_size=2)
        config = getattr(mod, name)(**{**kw, **extra, **over})
        for k, v in AUDIO.items():
            setattr(config.audio, k, v)
        out.append(config)
    return tuple(out)


def waveform_batch(B=2, T=SEQ_LEN, seed=0):
    """``{"waveform": [B, T, 1], "mel": [B, T / 64, 16]}``: voiced noise and
    its log-mel, numpy float32."""
    rs = np.random.RandomState(seed)
    t = np.arange(T) / AUDIO["sample_rate"]
    wav = np.stack([0.4 * np.sin(2 * np.pi * rs.uniform(100, 300) * t) + 0.05 * rs.randn(T)
                    for _ in range(B)]).astype(np.float32)
    frames = T // AUDIO["hop_length"]
    mel = rs.randn(B, frames, AUDIO["num_mels"]).astype(np.float32)
    return {"waveform": wav[..., None], "mel": mel}


def write_wavs(root, n: int, seconds=(0.05, 0.3), seed: int = 0, sr: int = 22050) -> list:
    """``n`` 16-bit voiced clips under ``root`` in two nested folders;
    returns their paths."""
    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        folder = os.path.join(root, "a" if i % 2 else os.path.join("b", "c"))
        os.makedirs(folder, exist_ok=True)
        m = int(rs.uniform(*seconds) * sr)
        t = np.arange(m) / sr
        wav = 0.3 * np.sin(2 * np.pi * rs.uniform(90, 240) * t) + 0.01 * rs.randn(m)
        path = os.path.join(folder, f"clip{i:03d}.wav")
        scipy.io.wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        paths.append(path)
    return paths
