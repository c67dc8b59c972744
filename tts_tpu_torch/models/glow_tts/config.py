"""Copied from ``tts_tpu/models/glow_tts/config.py`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``GlowTTSConfig`` (reference ``TTS/tts/configs/glow_tts_config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class GlowTTSConfig(BaseTTSConfig):
    model: str = "glow_tts"

    # model params
    num_chars: Optional[int] = None
    encoder_type: str = "rel_pos_transformer"
    encoder_params: dict = field(
        default_factory=lambda: {
            "kernel_size": 3,
            "dropout_p": 0.1,
            "num_layers": 6,
            "num_heads": 2,
            "hidden_channels_ffn": 768,
        }
    )
    use_encoder_prenet: bool = True
    hidden_channels_enc: int = 192
    hidden_channels_dec: int = 192
    hidden_channels_dp: int = 256
    dropout_p_dp: float = 0.1
    dropout_p_dec: float = 0.05
    mean_only: bool = True
    out_channels: int = 80
    num_flow_blocks_dec: int = 12
    kernel_size_dec: int = 5
    dilation_rate: int = 1
    num_block_layers: int = 4
    num_splits: int = 4
    num_squeeze: int = 2
    sigmoid_scale: bool = False
    dropout_p_dec_inference: float = 0.0
    inference_noise_scale: float = 0.0
    length_scale: float = 1.0

    # multi-speaker
    num_speakers: int = 0
    c_in_channels: int = 0
    use_speaker_embedding: bool = False
    speakers_file: Optional[str] = None
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None
    d_vector_dim: int = 0
    data_dep_init_steps: int = 10
    style_wav_for_test: Optional[str] = None

    # optimization (reference defaults)
    optimizer: str = "RAdam"
    optimizer_params: dict = field(
        default_factory=lambda: {"betas": [0.9, 0.998], "weight_decay": 1e-6}
    )
    lr_scheduler: str = "NoamLR"
    lr_scheduler_params: dict = field(default_factory=lambda: {"warmup_steps": 4000})
    grad_clip: float = 5.0
    lr: float = 1e-3
    r: int = 1

    min_seq_len: int = 3
    max_seq_len: int = 500

    test_sentences: List[str] = field(
        default_factory=lambda: [
            "It took me quite a long time to develop a voice, and now that I have it I'm not going to be silent.",
            "Be a voice, not an echo.",
            "I'm sorry Dave. I'm afraid I can't do that.",
            "This cake is great. It's so delicious and moist.",
            "Prior to November 22, 1963.",
        ]
    )
