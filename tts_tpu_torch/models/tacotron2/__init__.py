"""Tacotron2 and Tacotron v1 in PyTorch (port of ``tts_tpu.models.tacotron2``):
inference."""

from .config import Tacotron2Config, TacotronConfig  # noqa: F401
from .model import Tacotron2, Tacotron2Module  # noqa: F401
from .tacotron_v1 import Tacotron, TacotronModule  # noqa: F401
