"""Copied from ``tts_tpu/encoder/configs.py`` (the port imports nothing of
``tts_tpu``), unchanged apart from this docstring and import paths: the
speaker and emotion encoder configs (reference ``TTS/encoder/configs/``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from tts_tpu_torch.config.shared import BaseAudioConfig, BaseTrainingConfig


@dataclass
class BaseEncoderConfig(BaseTrainingConfig):
    model: str = ""
    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    # training
    num_classes_in_batch: int = 32
    num_utter_per_class: int = 4
    eval_num_classes_in_batch: Optional[int] = None
    eval_num_utter_per_class: Optional[int] = None
    max_train_step: int = 1000000
    loss: str = "angleproto"
    grad_clip: float = 3.0
    lr: float = 0.0001
    optimizer: str = "radam"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.9, 0.999], "weight_decay": 0})
    # model
    model_params: dict = field(
        default_factory=lambda: {
            "model_name": "lstm",
            "input_dim": 80,
            "proj_dim": 256,
            "lstm_dim": 768,
            "num_lstm_layers": 3,
            "use_lstm_with_projection": True,
        }
    )
    audio_augmentation: dict = field(default_factory=dict)
    voice_len: float = 1.6


@dataclass
class SpeakerEncoderConfig(BaseEncoderConfig):
    model: str = "speaker_encoder"
    class_name_key: str = "speaker_name"


@dataclass
class EmotionEncoderConfig(BaseEncoderConfig):
    model: str = "emotion_encoder"
    class_name_key: str = "emotion_name"
    map_classid_to_classname: dict = field(default_factory=dict)
