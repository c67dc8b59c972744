"""Copied from ``tts_tpu/models/overflow/config.py`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``NeuralhmmTTSConfig`` and ``OverflowConfig`` (reference
``TTS/tts/configs/{overflow,neuralhmm_tts}_config.py``).

The JAX config has no ``sampling_temp``: a ``config.json`` carrying one
(the reference's) is read by neither package (ROADMAP.md F30)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class NeuralhmmTTSConfig(BaseTTSConfig):
    norm_type: str = "layer"
    # dataset mel statistics (reference mean/std buffers, overflow.py:110)
    mel_statistics_mean: float = 0.0
    mel_statistics_std: float = 1.0
    model: str = "neuralhmm_tts"

    num_chars: Optional[int] = None
    out_channels: int = 80
    state_per_phone: int = 2
    encoder_in_out_features: int = 512
    encoder_n_convolutions: int = 3

    # HMM
    memory_rnn_dim: int = 1024
    prenet_type: str = "original"
    prenet_dim: int = 256
    prenet_n_layers: int = 2
    prenet_dropout: float = 0.5
    prenet_dropout_at_inference: bool = False
    outputnet_size: List[int] = field(default_factory=lambda: [1024])
    flat_start_params: dict = field(
        default_factory=lambda: {"mean": 0.0, "std": 1.0, "transition_p": 0.14}
    )
    std_floor: float = 0.001
    max_sampling_time: int = 1000
    duration_threshold: float = 0.43
    deterministic_transition: bool = True

    # optimization
    optimizer: str = "Adam"
    optimizer_params: dict = field(default_factory=lambda: {"weight_decay": 1e-6})
    grad_clip: float = 40000.0
    lr: float = 1e-3
    lr_scheduler: Optional[str] = None
    min_seq_len: int = 3
    max_seq_len: int = 500
    r: int = 1


@dataclass
class OverflowConfig(NeuralhmmTTSConfig):
    model: str = "overflow"
    # glow post-flow decoder
    hidden_channels_dec: int = 150
    kernel_size_dec: int = 5
    dilation_rate: int = 1
    num_flow_blocks_dec: int = 12
    num_block_layers: int = 4
    dropout_p_dec: float = 0.05
    num_splits: int = 4
    num_squeeze: int = 2
    sigmoid_scale: bool = False
    c_in_channels: int = 0
