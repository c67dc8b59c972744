"""GlowTTS in PyTorch (port of ``tts_tpu.models.glow_tts``): inference."""

from .config import GlowTTSConfig  # noqa: F401
from .model import GlowTTS, GlowTTSModule  # noqa: F401
