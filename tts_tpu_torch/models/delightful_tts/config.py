"""Copied from ``tts_tpu/models/delightful_tts/config.py`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``DelightfulTtsAudioConfig``, ``VocoderConfig``, ``DelightfulTtsArgs`` and
``DelightfulTTSConfig`` (reference ``TTS/tts/models/delightful_tts.py:529``
+ ``configs/delightful_tts_config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class DelightfulTtsAudioConfig(Config):
    sample_rate: int = 22050
    hop_length: int = 256
    win_length: int = 1024
    fft_size: int = 1024
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    num_mels: int = 100
    pitch_fmax: float = 640.0
    pitch_fmin: float = 1.0


@dataclass
class VocoderConfig(Config):
    resblock_type_decoder: str = "1"
    resblock_kernel_sizes_decoder: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes_decoder: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_rates_decoder: List[int] = field(default_factory=lambda: [8, 8, 2, 2])
    upsample_initial_channel_decoder: int = 512
    upsample_kernel_sizes_decoder: List[int] = field(default_factory=lambda: [16, 16, 4, 4])
    periods_discriminator: List[int] = field(default_factory=lambda: [2, 3, 5, 7, 11])
    # <1.0 shrinks the fixed discriminator channel plans (tests/CI)
    discriminator_width_mult: float = 1.0


@dataclass
class DelightfulTtsArgs(Config):
    """Mirrors reference ``DelightfulTtsArgs`` (delightful_tts.py:579)."""

    num_chars: Optional[int] = 100
    spec_segment_size: int = 32
    # conformer
    n_hidden_conformer_encoder: int = 512
    n_layers_conformer_encoder: int = 6
    n_heads_conformer_encoder: int = 8
    dropout_conformer_encoder: float = 0.1
    kernel_size_conv_mod_conformer_encoder: int = 7
    lrelu_slope: float = 0.3
    n_hidden_conformer_decoder: int = 512
    n_layers_conformer_decoder: int = 6
    n_heads_conformer_decoder: int = 8
    dropout_conformer_decoder: float = 0.1
    kernel_size_conv_mod_conformer_decoder: int = 11
    # prosody reference encoders
    bottleneck_size_p_reference_encoder: int = 4
    bottleneck_size_u_reference_encoder: int = 512
    ref_enc_filters_reference_encoder: List[int] = field(
        default_factory=lambda: [32, 32, 64, 64, 128, 128]
    )
    ref_enc_size_reference_encoder: int = 3
    ref_enc_strides_reference_encoder: List[int] = field(
        default_factory=lambda: [1, 2, 1, 2, 1]
    )
    ref_enc_gru_size_reference_encoder: int = 32
    token_num_reference_encoder: int = 32
    predictor_kernel_size_reference_encoder: int = 5
    # variance adaptors
    n_hidden_variance_adaptor: int = 512
    kernel_size_variance_adaptor: int = 5
    dropout_variance_adaptor: float = 0.5
    emb_kernel_size_variance_adaptor: int = 3
    # legacy compact-variant knobs (kept for config compatibility)
    duration_predictor_hidden: int = 256
    pitch_predictor_hidden: int = 256
    energy_predictor_hidden: int = 256
    # speakers
    num_speakers: int = 0
    use_speaker_embedding: bool = False
    speaker_embedding_channels: int = 384
    use_d_vector_file: bool = False
    d_vector_dim: int = 0
    length_scale: float = 1.0
    pad_id: int = 0


@dataclass
class DelightfulTTSConfig(BaseTTSConfig):
    model: str = "delightful_tts"
    model_args: DelightfulTtsArgs = field(default_factory=DelightfulTtsArgs)
    audio: DelightfulTtsAudioConfig = field(default_factory=DelightfulTtsAudioConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)

    # two-optimizer GAN training (joint acoustic + vocoder)
    steps_to_start_discriminator: int = 200000
    grad_clip: List[float] = field(default_factory=lambda: [1000.0, 1000.0])
    lr_gen: float = 0.0002
    lr_disc: float = 0.0002
    lr_scheduler_gen: str = "ExponentialLR"
    lr_scheduler_gen_params: dict = field(default_factory=lambda: {"gamma": 0.999875})
    lr_scheduler_disc: str = "ExponentialLR"
    lr_scheduler_disc_params: dict = field(default_factory=lambda: {"gamma": 0.999875})
    optimizer: str = "AdamW"
    optimizer_params: dict = field(
        default_factory=lambda: {"betas": [0.8, 0.99], "eps": 1e-9, "weight_decay": 0.01}
    )
    # loss weights (reference delightful_tts.py:1583)
    mel_loss_alpha: float = 45.0
    aligner_loss_alpha: float = 1.0
    pitch_loss_alpha: float = 1.0
    energy_loss_alpha: float = 1.0
    u_prosody_loss_alpha: float = 0.5
    p_prosody_loss_alpha: float = 0.5
    dur_loss_alpha: float = 1.0
    char_dur_loss_alpha: float = 0.01
    binary_align_loss_alpha: float = 0.1
    feat_loss_alpha: float = 1.0
    vocoder_mel_loss_alpha: float = 10.0
    gen_loss_alpha: float = 1.0
    disc_loss_alpha: float = 1.0
    binary_loss_warmup_epochs: int = 10

    compute_f0: bool = True
    f0_cache_path: Optional[str] = None
    compute_energy: bool = True
    energy_cache_path: Optional[str] = None
    return_wav: bool = True
