"""Config classes and loading: the port's own copies of
``tts_tpu/config/base.py`` and ``shared.py``, and from
``tts_tpu/config/__init__.py`` only ``read_json_with_comments`` (the model
registry of the port lives in ``tts_tpu_torch.models``)."""

from __future__ import annotations

import json
import re
from typing import Dict

from .base import Config
from .shared import BaseTTSConfig

__all__ = ["BaseTTSConfig", "Config", "read_json_with_comments"]


def read_json_with_comments(json_path: str) -> Dict:
    """Read a JSON file tolerating ``//`` and ``/* */`` comments."""
    with open(json_path, "r", encoding="utf-8") as f:
        data = f.read()
    data = re.sub(r"\\\n", "", data)
    data = re.sub(r"//.*\n", "\n", data)
    data = re.sub(r"/\*(.|\n)*?\*/", "", data)
    return json.loads(data)
