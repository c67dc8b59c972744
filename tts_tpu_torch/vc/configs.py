"""Copied from ``tts_tpu/vc/configs.py`` (the port imports nothing of
``tts_tpu``), unchanged apart from this docstring and import paths: the
FreeVC config (reference ``TTS/vc/configs/freevc_config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTrainingConfig


@dataclass
class FreeVCAudioConfig(Config):
    max_wav_value: float = 32768.0
    input_sample_rate: int = 16000
    output_sample_rate: int = 24000
    filter_length: int = 1280
    hop_length: int = 320
    win_length: int = 1280
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None


@dataclass
class FreeVCArgs(Config):
    spec_channels: int = 641
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_rates: List[int] = field(default_factory=lambda: [10, 8, 2, 2])
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [16, 16, 4, 4])
    segment_size: int = 8960
    gin_channels: int = 256
    ssl_dim: int = 1024
    use_spk: bool = False  # reference freevc_config.py:134 (in-model enc_spk)
    num_spks: int = 0


@dataclass
class FreeVCConfig(BaseTrainingConfig):
    model: str = "freevc"
    model_args: FreeVCArgs = field(default_factory=FreeVCArgs)
    audio: FreeVCAudioConfig = field(default_factory=FreeVCAudioConfig)
