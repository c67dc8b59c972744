"""Copied from ``tts_tpu/vocoder/configs.py:1-176`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``BaseVocoderConfig``, ``BaseGANVocoderConfig``, ``HifiganConfig``,
``MelganConfig``, ``MultibandMelganConfig`` and ``FullbandMelganConfig``
(reference ``TTS/vocoder/configs/``). The configs of the vocoders the port
does not run yet (ParallelWaveGAN, UnivNet, WaveGrad, WaveRNN) wait for
them (ROADMAP.md item 16)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.shared import BaseAudioConfig, BaseTrainingConfig


@dataclass
class BaseVocoderConfig(BaseTrainingConfig):
    """(reference ``shared_configs.py`` BaseVocoderConfig)"""

    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    use_noise_augment: bool = False
    eval_split_size: int = 10
    data_path: str = ""
    feature_path: Optional[str] = None
    seq_len: int = 1000
    pad_short: int = 0
    conv_pad: int = 0
    use_cache: bool = False
    epochs: int = 10000
    wd: float = 0.0
    optimizer: str = "AdamW"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.8, 0.99], "weight_decay": 0.0})


@dataclass
class BaseGANVocoderConfig(BaseVocoderConfig):
    """(reference ``shared_configs.py`` BaseGANVocoderConfig)"""

    model: str = "gan"
    generator_model: str = "hifigan_generator"
    generator_model_params: dict = field(default_factory=dict)
    discriminator_model: str = "hifigan_discriminator"
    discriminator_model_params: dict = field(default_factory=dict)

    use_stft_loss: bool = True
    use_subband_stft_loss: bool = True
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = True
    use_l1_spec_loss: bool = True
    stft_loss_weight: float = 0.0
    subband_stft_loss_weight: float = 0.0
    mse_G_loss_weight: float = 1.0
    hinge_G_loss_weight: float = 0.0
    feat_match_loss_weight: float = 100.0
    l1_spec_loss_weight: float = 45.0
    stft_loss_params: dict = field(
        default_factory=lambda: {
            "n_ffts": [1024, 2048, 512],
            "hop_lengths": [120, 240, 50],
            "win_lengths": [600, 1200, 240],
        }
    )
    subband_stft_loss_params: dict = field(
        default_factory=lambda: {
            "n_ffts": [384, 683, 171],
            "hop_lengths": [30, 60, 10],
            "win_lengths": [150, 300, 60],
        }
    )
    target_loss: str = "loss_0"
    grad_clip: List[float] = field(default_factory=lambda: [5.0, 5.0])
    lr_gen: float = 0.0002
    lr_disc: float = 0.0002
    lr_scheduler_gen: Optional[str] = "ExponentialLR"
    lr_scheduler_gen_params: dict = field(default_factory=lambda: {"gamma": 0.999, "last_epoch": -1})
    lr_scheduler_disc: Optional[str] = "ExponentialLR"
    lr_scheduler_disc_params: dict = field(default_factory=lambda: {"gamma": 0.999, "last_epoch": -1})
    scheduler_after_epoch: bool = True
    use_pqmf: bool = False
    steps_to_start_discriminator: int = 0
    diff_samples_for_G_and_D: bool = False


@dataclass
class HifiganConfig(BaseGANVocoderConfig):
    """(reference ``hifigan_config.py``)"""

    model: str = "hifigan"
    generator_model: str = "hifigan_generator"
    discriminator_model: str = "hifigan_discriminator"
    generator_model_params: dict = field(
        default_factory=lambda: {
            "upsample_factors": [8, 8, 2, 2],
            "upsample_kernel_sizes": [16, 16, 4, 4],
            "upsample_initial_channel": 512,
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "resblock_type": "1",
        }
    )
    use_stft_loss: bool = False
    use_subband_stft_loss: bool = False
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = True
    use_l1_spec_loss: bool = True
    stft_loss_weight: float = 0.0
    subband_stft_loss_weight: float = 0.0
    mse_G_loss_weight: float = 1.0
    feat_match_loss_weight: float = 108.0
    l1_spec_loss_weight: float = 45.0
    seq_len: int = 8192
    pad_short: int = 2000
    lr_gen: float = 1e-4
    lr_disc: float = 1e-4


@dataclass
class MelganConfig(BaseGANVocoderConfig):
    """(reference ``melgan_config.py``)"""

    model: str = "melgan"
    generator_model: str = "melgan_generator"
    discriminator_model: str = "melgan_multiscale_discriminator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [8, 8, 2, 2], "num_res_blocks": 3}
    )
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = False
    use_feat_match_loss: bool = False
    use_l1_spec_loss: bool = False
    stft_loss_weight: float = 0.5
    mse_G_loss_weight: float = 2.5
    feat_match_loss_weight: float = 108.0
    seq_len: int = 16384
    pad_short: int = 2000


@dataclass
class MultibandMelganConfig(BaseGANVocoderConfig):
    """(reference ``multiband_melgan_config.py``)"""

    model: str = "multiband_melgan"
    generator_model: str = "multiband_melgan_generator"
    discriminator_model: str = "melgan_multiscale_discriminator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [8, 4, 2], "num_res_blocks": 4}
    )
    discriminator_model_params: dict = field(
        default_factory=lambda: {
            "base_channels": 16,
            "max_channels": 512,
            "downsample_factors": [4, 4, 4],
        }
    )
    use_pqmf: bool = True
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = True
    use_feat_match_loss: bool = False
    use_l1_spec_loss: bool = False
    stft_loss_weight: float = 0.5
    subband_stft_loss_weight: float = 0.5
    mse_G_loss_weight: float = 2.5
    steps_to_start_discriminator: int = 200000
    seq_len: int = 16384
    pad_short: int = 2000
    lr_gen: float = 1e-4
    lr_disc: float = 1e-4


@dataclass
class FullbandMelganConfig(MelganConfig):
    model: str = "fullband_melgan"
    generator_model: str = "fullband_melgan_generator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [8, 8, 2, 2], "num_res_blocks": 4}
    )
