"""Copied from ``tts_tpu/models/align_tts/config.py`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``AlignTTSArgs`` and ``AlignTTSConfig`` (reference
``TTS/tts/configs/align_tts_config.py`` + ``models/align_tts.py:22``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class AlignTTSArgs(Config):
    num_chars: Optional[int] = None
    out_channels: int = 80
    hidden_channels: int = 256
    hidden_channels_dp: int = 256
    encoder_type: str = "fftransformer"
    encoder_params: dict = field(
        default_factory=lambda: {
            "hidden_channels_ffn": 1024,
            "num_heads": 2,
            "num_layers": 6,
            "dropout_p": 0.1,
        }
    )
    decoder_type: str = "fftransformer"
    decoder_params: dict = field(
        default_factory=lambda: {
            "hidden_channels_ffn": 1024,
            "num_heads": 2,
            "num_layers": 6,
            "dropout_p": 0.1,
        }
    )
    length_scale: float = 1.0
    num_speakers: int = 0
    use_speaker_embedding: bool = False
    use_d_vector_file: bool = False
    d_vector_dim: int = 0


@dataclass
class AlignTTSConfig(BaseTTSConfig):
    model: str = "align_tts"
    model_args: AlignTTSArgs = field(default_factory=AlignTTSArgs)
    # multi-phase schedule: step boundaries per phase (reference
    # align_tts.py:414 _set_phase; -1 = single-phase joint training)
    phase_start_steps: Optional[List[int]] = None

    ssim_alpha: float = 1.0
    spec_loss_alpha: float = 1.0
    dur_loss_alpha: float = 1.0
    mdn_alpha: float = 1.0

    # multi-speaker mirrors
    use_speaker_embedding: bool = False
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None

    optimizer: str = "Adam"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.9, 0.998], "weight_decay": 1e-6})
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: dict = field(default_factory=dict)
    lr: float = 1e-4
    grad_clip: float = 5.0
    min_seq_len: int = 2
    max_seq_len: int = 300
    r: int = 1
