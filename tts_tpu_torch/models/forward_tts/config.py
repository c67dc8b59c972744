"""Copied from ``tts_tpu/models/forward_tts/config.py`` (the port imports
nothing of ``tts_tpu``), unchanged apart from this docstring and import paths:
``ForwardTTSArgs`` and the family's configs (reference
``TTS/tts/models/forward_tts.py:23`` and ``configs/{fast_pitch,fast_speech,
fastspeech2,speedy_speech}_config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class ForwardTTSArgs(Config):
    num_chars: Optional[int] = None
    out_channels: int = 80
    hidden_channels: int = 384
    use_aligner: bool = True
    # pitch
    use_pitch: bool = True
    pitch_predictor_hidden_channels: int = 256
    pitch_predictor_kernel_size: int = 3
    pitch_predictor_dropout_p: float = 0.1
    pitch_embedding_kernel_size: int = 3
    # energy
    use_energy: bool = False
    energy_predictor_hidden_channels: int = 256
    energy_predictor_kernel_size: int = 3
    energy_predictor_dropout_p: float = 0.1
    energy_embedding_kernel_size: int = 3
    # duration
    duration_predictor_hidden_channels: int = 256
    duration_predictor_kernel_size: int = 3
    duration_predictor_dropout_p: float = 0.1
    positional_encoding: bool = True
    positional_encoding_use_scale: bool = False  # reference typo 'poisitonal...' means scale is never used
    length_scale: float = 1.0
    encoder_type: str = "fftransformer"
    encoder_params: dict = field(
        default_factory=lambda: {
            "hidden_channels_ffn": 1024,
            "num_heads": 1,
            "num_layers": 6,
            "dropout_p": 0.1,
        }
    )
    decoder_type: str = "fftransformer"
    decoder_params: dict = field(
        default_factory=lambda: {
            "hidden_channels_ffn": 1024,
            "num_heads": 1,
            "num_layers": 6,
            "dropout_p": 0.1,
        }
    )
    detach_duration_predictor: bool = False
    max_duration: int = 75
    num_speakers: int = 1
    use_speaker_embedding: bool = False
    speakers_file: Optional[str] = None
    use_d_vector_file: bool = False
    d_vector_dim: Optional[int] = None
    d_vector_file: Optional[str] = None


@dataclass
class ForwardTTSConfig(BaseTTSConfig):
    """Shared training config for the family."""

    model: str = "forward_tts"
    base_model: str = "forward_tts"
    model_args: ForwardTTSArgs = field(default_factory=ForwardTTSArgs)

    # multi-speaker mirror fields
    num_speakers: int = 0
    speakers_file: Optional[str] = None
    use_speaker_embedding: bool = False
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None
    d_vector_dim: int = 0

    # optimization (fast_pitch_config defaults)
    optimizer: str = "Adam"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.9, 0.998], "weight_decay": 1e-6})
    lr_scheduler: str = "NoamLR"
    lr_scheduler_params: dict = field(default_factory=lambda: {"warmup_steps": 4000})
    lr: float = 1e-4
    grad_clip: float = 5.0

    # loss weights
    spec_loss_type: str = "mse"
    duration_loss_type: str = "mse"
    use_ssim_loss: bool = True
    ssim_loss_alpha: float = 1.0
    spec_loss_alpha: float = 1.0
    aligner_loss_alpha: float = 1.0
    pitch_loss_alpha: float = 0.1
    energy_loss_alpha: float = 0.1
    dur_loss_alpha: float = 0.1
    binary_align_loss_alpha: float = 0.1
    binary_loss_warmup_epochs: int = 150

    min_seq_len: int = 13
    max_seq_len: int = 200
    r: int = 1


@dataclass
class FastPitchConfig(ForwardTTSConfig):
    model: str = "fast_pitch"
    compute_f0: bool = True
    f0_cache_path: Optional[str] = None


@dataclass
class FastSpeechConfig(ForwardTTSConfig):
    model: str = "fast_speech"
    model_args: ForwardTTSArgs = field(default_factory=lambda: ForwardTTSArgs(use_pitch=False))


@dataclass
class Fastspeech2Config(ForwardTTSConfig):
    model: str = "fastspeech2"
    model_args: ForwardTTSArgs = field(
        default_factory=lambda: ForwardTTSArgs(use_pitch=True, use_energy=True)
    )
    compute_f0: bool = True
    f0_cache_path: Optional[str] = None
    compute_energy: bool = True
    energy_cache_path: Optional[str] = None


@dataclass
class SpeedySpeechConfig(ForwardTTSConfig):
    model: str = "speedy_speech"
    model_args: ForwardTTSArgs = field(
        default_factory=lambda: ForwardTTSArgs(
            use_pitch=False,
            hidden_channels=128,
            positional_encoding=True,
            detach_duration_predictor=True,
            encoder_type="residual_conv_bn",
            encoder_params={
                "kernel_size": 4,
                "dilations": [1, 2, 4, 1, 2, 4, 1, 2, 4, 1, 2, 4, 1],
                "num_conv_blocks": 2,
                "num_res_blocks": 13,
            },
            decoder_type="residual_conv_bn",
            decoder_params={
                "kernel_size": 4,
                "dilations": [1, 2, 4, 8, 1, 2, 4, 8, 1, 2, 4, 8, 1, 2, 4, 8, 1],
                "num_conv_blocks": 2,
                "num_res_blocks": 17,
            },
        )
    )
    use_ssim_loss: bool = False
    spec_loss_type: str = "l1"
    duration_loss_type: str = "huber"
