"""Tortoise config (port of ``tts_tpu/models/tortoise/config.py``, reference
``TTS/tts/configs/tortoise_config.py``).

Redeclared on the port's own ``config.base.Config``; the fields and defaults
are the JAX package's, so a ``config.json`` written by either package loads
in the other, and the reference's own ``config.json`` (other field names)
loads with these defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class TortoiseAudioConfig(Config):
    sample_rate: int = 22050
    output_sample_rate: int = 24000


@dataclass
class TortoiseArgs(Config):
    # autoregressive UnifiedVoice (reference autoregressive.py:262)
    ar_layers: int = 30
    ar_model_dim: int = 1024
    ar_heads: int = 16
    ar_max_text_tokens: int = 402
    ar_max_mel_tokens: int = 604
    ar_number_text_tokens: int = 255
    ar_number_mel_codes: int = 8194
    ar_start_mel_token: int = 8192
    ar_stop_mel_token: int = 8193
    ar_start_text_token: int = 255
    ar_stop_text_token: int = 0
    num_conditioning_latents: int = 1
    # diffusion decoder (reference diffusion_decoder.py:141)
    diff_model_channels: int = 1024
    diff_num_layers: int = 10
    diff_in_channels: int = 100
    diff_in_latent_channels: int = 1024
    diff_out_channels: int = 200
    diff_num_heads: int = 16
    # bundled UnivNet vocoder (reference tortoise/vocoder.py:277 defaults)
    voc_noise_dim: int = 64
    voc_channel_size: int = 32
    voc_strides: tuple = (8, 8, 4)
    # sampling
    num_autoregressive_samples: int = 16
    diffusion_iterations: int = 30
    temperature: float = 0.8
    top_p: float = 0.8
    repetition_penalty: float = 2.0
    cond_free: bool = True
    cond_free_k: float = 2.0
    sampler: str = "ddim"  # "ddim" | "dpm++2m" (reference dpm_solver.py)
    diffusion_temperature: float = 1.0


@dataclass
class TortoiseConfig(BaseTTSConfig):
    model: str = "tortoise"
    model_args: TortoiseArgs = field(default_factory=TortoiseArgs)
    audio: TortoiseAudioConfig = field(default_factory=TortoiseAudioConfig)
    model_dir: Optional[str] = None
