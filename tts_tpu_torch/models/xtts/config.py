"""XTTS config (port of ``tts_tpu/models/xtts/config.py``).

Redeclared on the port's own ``config.base.Config`` (a copy of
``tts_tpu/config/base.py``): the port imports nothing of ``tts_tpu``. The fields and defaults are the
JAX package's, so a ``config.json`` written by either package loads in the
other. The training-only fields for work the port does not do yet (remat,
sequence-parallel fine-tuning) are kept for that compatibility and ignored.
``gpt_int8_weights=True`` stores the GPT's matmul weights as int8 with
per-channel scales (``Xtts.quantize_weights_int8``, ``ops/quant.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class XttsAudioConfig(Config):
    sample_rate: int = 22050
    output_sample_rate: int = 24000


@dataclass
class XttsArgs(Config):
    """Model arguments; defaults are XTTS v2."""

    gpt_batch_size: int = 1
    enable_redaction: bool = False
    kv_cache: bool = True
    gpt_checkpoint: Optional[str] = None
    clvp_checkpoint: Optional[str] = None
    decoder_checkpoint: Optional[str] = None
    num_chars: int = 255

    # GPT
    gpt_max_audio_tokens: int = 605
    gpt_max_text_tokens: int = 402
    gpt_max_prompt_tokens: int = 70
    gpt_layers: int = 30
    gpt_n_model_channels: int = 1024
    gpt_n_heads: int = 16
    gpt_number_text_tokens: int = 6681
    gpt_start_text_token: Optional[int] = None
    gpt_stop_text_token: Optional[int] = None
    gpt_num_audio_tokens: int = 1026
    gpt_start_audio_token: int = 1024
    gpt_stop_audio_token: int = 1025
    gpt_code_stride_len: int = 1024
    gpt_use_masking_gt_prompt_approach: bool = True
    gpt_use_perceiver_resampler: bool = True
    # training options of the JAX package (not ported yet, ignored)
    gpt_use_remat: bool = False
    gpt_seq_parallel: bool = False
    # serving: the GPT's matmul weights as int8 with per-channel scales,
    # multiplied by K4 (ops/quant.py), after load_checkpoint and init_params
    gpt_int8_weights: bool = False

    # fine-tune dataset limits
    min_conditioning_length: int = 66150
    max_conditioning_length: int = 132300
    max_wav_length: int = 255995  # ~11.6 s @ 22050
    max_text_length: int = 200

    # HiFi decoder
    input_sample_rate: int = 22050
    output_sample_rate: int = 24000
    output_hop_length: int = 256
    decoder_input_dim: int = 1024
    d_vector_dim: int = 512
    cond_d_vector_in_each_upsampling_layer: bool = True

    # inference
    duration_const: int = 102400


@dataclass
class XttsConfig(BaseTTSConfig):
    model: str = "xtts"
    model_args: XttsArgs = field(default_factory=XttsArgs)
    audio: XttsAudioConfig = field(default_factory=XttsAudioConfig)
    model_dir: Optional[str] = None
    languages: List[str] = field(
        default_factory=lambda: [
            "en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru", "nl",
            "cs", "ar", "zh-cn", "hu", "ko", "ja", "hi",
        ]
    )
    # inference sampling defaults
    temperature: float = 0.75
    length_penalty: float = 1.0
    repetition_penalty: float = 5.0
    top_k: int = 50
    top_p: float = 0.85
    num_gpt_outputs: int = 1
    gpt_cond_len: int = 30
    gpt_cond_chunk_len: int = 4
    max_ref_len: int = 30
    sound_norm_refs: bool = False
