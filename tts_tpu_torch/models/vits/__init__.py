"""VITS in PyTorch (port of ``tts_tpu.models.vits``), single-speaker inference."""

from .config import VitsArgs, VitsAudioConfig, VitsConfig  # noqa: F401
from .model import Vits, VitsModule  # noqa: F401
