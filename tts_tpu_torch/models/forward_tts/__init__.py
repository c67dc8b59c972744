"""The ForwardTTS family in PyTorch (port of ``tts_tpu.models.forward_tts``):
inference."""

from .config import (  # noqa: F401
    FastPitchConfig,
    FastSpeechConfig,
    Fastspeech2Config,
    ForwardTTSArgs,
    ForwardTTSConfig,
    SpeedySpeechConfig,
)
from .model import ForwardTTS, ForwardTTSModule  # noqa: F401
