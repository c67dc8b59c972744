"""Copied from ``tts_tpu/models/tacotron2/config.py`` (the port imports nothing
of ``tts_tpu``), unchanged apart from this docstring and import paths:
``TacotronConfig`` and ``Tacotron2Config`` (reference
``TTS/tts/configs/tacotron_config.py`` + ``tacotron2_config.py``).

The model reads ``attention_win`` and, as the JAX model does, ignores
``windowing`` and ``forward_attn_mask``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class TacotronConfig(BaseTTSConfig):
    # "layer" for training; "folded" = eval BatchNorm affine (converted ckpts)
    norm_type: str = "layer"
    model: str = "tacotron"
    use_gst: bool = False
    gst: Optional[dict] = None
    gst_style_input: Optional[str] = None
    use_capacitron_vae: bool = False
    capacitron_vae: Optional[dict] = None

    num_chars: Optional[int] = None
    num_speakers: int = 1
    r: int = 2
    gradual_training: Optional[List[List[int]]] = None
    memory_size: int = -1
    prenet_type: str = "original"
    prenet_dropout: bool = True
    prenet_dropout_at_inference: bool = False
    stopnet: bool = True
    separate_stopnet: bool = True
    stopnet_pos_weight: float = 0.2
    max_decoder_steps: int = 10000
    encoder_in_features: int = 256
    decoder_in_features: int = 256
    decoder_output_dim: int = 80
    out_channels: int = 513
    # module widths (reference sizes; tiny CI configs shrink them).
    # v1 embeds at 256 and uses CBHG banks; Tacotron2Config overrides.
    embedding_dim: int = 256
    query_dim: int = 1024
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    attn_dim: int = 128
    cbhg_K: int = 16
    post_cbhg_K: int = 8
    cbhg_features: int = 128

    # attention
    attention_type: str = "original"
    attention_heads: int = 4
    attention_norm: str = "sigmoid"
    attention_win: bool = False
    windowing: bool = False
    use_forward_attn: bool = False
    forward_attn_mask: bool = False
    transition_agent: bool = False
    location_attn: bool = True

    # multi-speaker
    use_speaker_embedding: bool = False
    speaker_embedding_dim: int = 512
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None
    d_vector_dim: Optional[int] = None

    # optimization
    optimizer: str = "RAdam"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.9, 0.998], "weight_decay": 1e-6})
    lr_scheduler: str = "NoamLR"
    lr_scheduler_params: dict = field(default_factory=lambda: {"warmup_steps": 4000})
    lr: float = 1e-4
    grad_clip: float = 5.0
    seq_len_norm: bool = False
    loss_masking: bool = True

    # loss params
    decoder_loss_alpha: float = 0.25
    postnet_loss_alpha: float = 0.25
    postnet_diff_spec_alpha: float = 0.25
    decoder_diff_spec_alpha: float = 0.25
    decoder_ssim_alpha: float = 0.25
    postnet_ssim_alpha: float = 0.25
    ga_alpha: float = 5.0

    # DDC
    double_decoder_consistency: bool = False
    ddc_r: int = 6


@dataclass
class Tacotron2Config(TacotronConfig):
    model: str = "tacotron2"
    out_channels: int = 80
    encoder_in_features: int = 512
    decoder_in_features: int = 512
    embedding_dim: int = 512
