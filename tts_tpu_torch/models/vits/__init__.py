"""VITS in PyTorch (port of ``tts_tpu.models.vits``): inference, speakers and
languages, and the GAN training step (``train.py``)."""

from .config import VitsArgs, VitsAudioConfig, VitsConfig  # noqa: F401
from .model import Vits, VitsModule  # noqa: F401
