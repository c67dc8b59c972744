"""AlignTTS in PyTorch (port of ``tts_tpu.models.align_tts``): inference."""

from .config import AlignTTSArgs, AlignTTSConfig  # noqa: F401
from .model import AlignTTS, AlignTTSModule  # noqa: F401
