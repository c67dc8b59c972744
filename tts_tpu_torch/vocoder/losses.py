"""Vocoder losses (port of ``tts_tpu/vocoder/losses.py``, reference
``TTS/vocoder/layers/losses.py``): the STFT losses, the (mel) spectrogram
L1, feature matching, the generator's composite loss and the
discriminator's.

The STFTs are ``audio/torch_transforms.py``'s strided convolution with the
windowed DFT basis, the same sums as the JAX package's. Every function
computes in fp32 whatever its inputs' type, as the JAX step's loss islands
do (``tts_tpu/vocoder/models/gan.py:88-92``). Waveforms are ``[B, T]`` for
the spectral losses and ``[B, T, 1]`` for :func:`generator_loss`, scores
and feature maps any shape.

:func:`discriminator_loss` takes the config's ``use_mse_gan_loss`` and
``use_hinge_gan_loss`` from the caller; the JAX step keeps the function's
defaults whatever the config says (ROADMAP.md F57), and the port's GAN
step passes the config's switches, as the reference's
``DiscriminatorLoss`` reads them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from tts_tpu_torch.audio.torch_transforms import stft_magnitude, wav_to_mel

__all__ = [
    "stft_loss",
    "multiscale_stft_loss",
    "l1_spec_loss",
    "feature_matching_loss",
    "GeneratorLossConfig",
    "generator_loss",
    "discriminator_loss",
]


def stft_loss(y_hat: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int):
    """``(spectral convergence, log-magnitude L1)`` of ``[B, T]`` waveforms
    (reference ``losses.py:15``)."""
    mag_hat = stft_magnitude(y_hat, n_fft, hop, win)
    mag = stft_magnitude(y, n_fft, hop, win)
    sc = torch.linalg.norm(mag - mag_hat) / torch.clamp(torch.linalg.norm(mag), min=1e-8)
    log_mag = torch.mean(torch.abs(torch.log(torch.clamp(mag, min=1e-5))
                                   - torch.log(torch.clamp(mag_hat, min=1e-5))))
    return sc, log_mag


def multiscale_stft_loss(y_hat, y, n_ffts: Sequence[int] = (1024, 2048, 512),
                         hops: Sequence[int] = (120, 240, 50),
                         wins: Sequence[int] = (600, 1200, 240)):
    """:func:`stft_loss` averaged over resolutions (reference ``losses.py:37``)."""
    sc_total, mag_total = 0.0, 0.0
    for n_fft, hop, win in zip(n_ffts, hops, wins):
        sc, mag = stft_loss(y_hat, y, n_fft, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(n_ffts)
    return sc_total / n, mag_total / n


def l1_spec_loss(y_hat, y, sample_rate, n_fft, hop, win, n_mels=None, fmin=0.0, fmax=None,
                 use_mel=True) -> torch.Tensor:
    """L1 between the log-mel (or magnitude) spectrograms of ``[B, T]``
    waveforms, centred frames (reference ``losses.py:61``)."""
    if use_mel:
        m_hat = wav_to_mel(y_hat, n_fft, n_mels, sample_rate, hop, win, fmin, fmax, center=True)
        m = wav_to_mel(y, n_fft, n_mels, sample_rate, hop, win, fmin, fmax, center=True)
    else:
        m_hat = stft_magnitude(y_hat, n_fft, hop, win)
        m = stft_magnitude(y, n_fft, hop, win)
    return torch.mean(torch.abs(m - m_hat))


def feature_matching_loss(feats_fake: List, feats_real: List) -> torch.Tensor:
    """Mean L1 over every feature map, the real maps held constant
    (reference ``losses.py:151`` MelganFeatureLoss)."""
    loss, count = 0.0, 0
    for ff, fr in zip(feats_fake, feats_real):
        for f_hat, f in zip(ff, fr):
            loss = loss + torch.mean(torch.abs(f_hat.float() - f.detach().float()))
            count += 1
    return loss / max(count, 1)


class GeneratorLossConfig:
    """The loss switches and weights of a vocoder config (the reference's
    field names)."""

    def __init__(self, config):
        self.use_stft_loss = getattr(config, "use_stft_loss", False)
        self.use_subband_stft_loss = getattr(config, "use_subband_stft_loss", False)
        self.use_mse_gan_loss = getattr(config, "use_mse_gan_loss", True)
        self.use_hinge_gan_loss = getattr(config, "use_hinge_gan_loss", False)
        self.use_feat_match_loss = getattr(config, "use_feat_match_loss", False)
        self.use_l1_spec_loss = getattr(config, "use_l1_spec_loss", False)
        self.stft_loss_weight = getattr(config, "stft_loss_weight", 0.0)
        self.subband_stft_loss_weight = getattr(config, "subband_stft_loss_weight", 0.0)
        self.mse_G_loss_weight = getattr(config, "mse_G_loss_weight", 1.0)
        self.hinge_G_loss_weight = getattr(config, "hinge_G_loss_weight", 0.0)
        self.feat_match_loss_weight = getattr(config, "feat_match_loss_weight", 0.0)
        self.l1_spec_loss_weight = getattr(config, "l1_spec_loss_weight", 0.0)
        self.stft_loss_params = getattr(config, "stft_loss_params", None) or {
            "n_ffts": [1024, 2048, 512],
            "hop_lengths": [120, 240, 50],
            "win_lengths": [600, 1200, 240],
        }
        self.subband_stft_loss_params = getattr(config, "subband_stft_loss_params", None) or {
            "n_ffts": [384, 683, 171],
            "hop_lengths": [30, 60, 10],
            "win_lengths": [150, 300, 60],
        }
        audio = config.audio
        get = (lambda k: audio[k]) if isinstance(audio, dict) else (  # noqa: E731
            lambda k: getattr(audio, k))
        self.l1_spec_params = dict(sample_rate=get("sample_rate"), n_fft=get("fft_size"),
                                   hop=get("hop_length"), win=get("win_length"),
                                   n_mels=get("num_mels"))


def generator_loss(cfg: GeneratorLossConfig, y_hat=None, y=None, scores_fake=None,
                   feats_fake=None, feats_real=None, y_hat_sub=None,
                   y_sub=None) -> Dict[str, torch.Tensor]:
    """The generator's composite loss (reference ``losses.py:218``
    GeneratorLoss): ``G_gen_loss`` (the STFT, sub-band STFT and mel L1
    terms), ``G_adv_loss`` (mse, hinge and feature matching), their sum
    ``G_loss`` and each term. ``y_hat``, ``y`` ``[B, T, 1]``; the sub-band
    signals ``[B, T / N, N]``."""
    out: Dict[str, torch.Tensor] = {}
    gen_loss = 0.0
    adv_loss = 0.0
    if cfg.use_stft_loss:
        p = cfg.stft_loss_params
        sc, mag = multiscale_stft_loss(y_hat[..., 0], y[..., 0], p["n_ffts"], p["hop_lengths"],
                                       p["win_lengths"])
        out["G_stft_loss_mg"] = mag
        out["G_stft_loss_sc"] = sc
        gen_loss = gen_loss + cfg.stft_loss_weight * (mag + sc)
    if cfg.use_subband_stft_loss and y_hat_sub is not None:
        p = cfg.subband_stft_loss_params
        B, T, N = y_hat_sub.shape
        sc, mag = multiscale_stft_loss(
            y_hat_sub.transpose(1, 2).reshape(B * N, T), y_sub.transpose(1, 2).reshape(B * N, T),
            p["n_ffts"], p["hop_lengths"], p["win_lengths"])
        out["G_subband_stft_loss_mg"] = mag
        out["G_subband_stft_loss_sc"] = sc
        gen_loss = gen_loss + cfg.subband_stft_loss_weight * (mag + sc)
    if cfg.use_l1_spec_loss:
        l1 = l1_spec_loss(y_hat[..., 0], y[..., 0], **cfg.l1_spec_params)
        out["G_l1_spec_loss"] = l1
        gen_loss = gen_loss + cfg.l1_spec_loss_weight * l1
    if cfg.use_mse_gan_loss and scores_fake is not None:
        mse = sum(torch.mean((1.0 - s.float()) ** 2) for s in scores_fake) / len(scores_fake)
        out["G_mse_fake_loss"] = mse
        adv_loss = adv_loss + cfg.mse_G_loss_weight * mse
    if cfg.use_hinge_gan_loss and scores_fake is not None:
        hinge = sum(-torch.mean(s.float()) for s in scores_fake) / len(scores_fake)
        out["G_hinge_fake_loss"] = hinge
        adv_loss = adv_loss + cfg.hinge_G_loss_weight * hinge
    if cfg.use_feat_match_loss and feats_fake is not None:
        fm = _tensor(feature_matching_loss(feats_fake, feats_real), y_hat)  # 0 without maps
        out["G_feat_match_loss"] = fm
        adv_loss = adv_loss + cfg.feat_match_loss_weight * fm
    out["G_loss"] = _tensor(gen_loss + adv_loss, y_hat)
    out["G_gen_loss"] = _tensor(gen_loss, y_hat)
    out["G_adv_loss"] = _tensor(adv_loss, y_hat)
    return out


def discriminator_loss(scores_fake, scores_real, use_mse: bool = True,
                       use_hinge: bool = False) -> Dict[str, torch.Tensor]:
    """The discriminator's loss over lists of scores (reference
    ``losses.py:311`` DiscriminatorLoss): least squares (fake toward 0,
    real toward 1) and, with ``use_hinge``, the hinge; ``D_loss`` their
    sum."""
    out: Dict[str, torch.Tensor] = {}
    loss = 0.0
    if use_mse:
        fake = sum(torch.mean(s.float() ** 2) for s in scores_fake) / len(scores_fake)
        real = sum(torch.mean((1.0 - s.float()) ** 2) for s in scores_real) / len(scores_real)
        out["D_mse_gan_loss"] = real + fake
        out["D_mse_gan_real_loss"] = real
        out["D_mse_gan_fake_loss"] = fake
        loss = loss + real + fake
    if use_hinge:
        fake = sum(torch.mean(F.relu(1.0 + s.float())) for s in scores_fake) / len(scores_fake)
        real = sum(torch.mean(F.relu(1.0 - s.float())) for s in scores_real) / len(scores_real)
        out["D_hinge_gan_loss"] = real + fake
        loss = loss + real + fake
    out["D_loss"] = _tensor(loss, scores_fake[0])
    return out


def _tensor(x, like) -> torch.Tensor:
    """``x`` as an fp32 tensor on ``like``'s device (a sum of no terms is
    the Python 0.0)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(float(x), device=like.device)
