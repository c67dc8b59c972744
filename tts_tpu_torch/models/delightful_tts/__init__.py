"""DelightfulTTS in PyTorch (port of ``tts_tpu.models.delightful_tts``):
inference, with its joint HiFiGAN."""

from .acoustic_model import AcousticModel  # noqa: F401
from .config import DelightfulTTSConfig, DelightfulTtsArgs  # noqa: F401
from .model import DelightfulTTS, DelightfulTTSModule  # noqa: F401
