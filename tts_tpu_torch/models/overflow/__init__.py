"""Overflow and NeuralHMM-TTS in PyTorch (port of ``tts_tpu.models.overflow``):
inference."""

from .config import NeuralhmmTTSConfig, OverflowConfig  # noqa: F401
from .model import NeuralhmmTTS, NeuralhmmTTSModule, Overflow  # noqa: F401
