"""Model registry of the port: config name → (config class, model class).

XTTS and VITS are ported so far; other names raise.
"""

from __future__ import annotations

import importlib
from typing import Dict

_MODELS = {
    "xtts": ("tts_tpu_torch.models.xtts.config:XttsConfig", "tts_tpu_torch.models.xtts.model:Xtts"),
    "vits": ("tts_tpu_torch.models.vits.config:VitsConfig", "tts_tpu_torch.models.vits.model:Vits"),
}


def _load(entry: str):
    mod, name = entry.split(":")
    return getattr(importlib.import_module(mod), name)


def _entry(model_name: str):
    name = (model_name or "").lower()
    if name not in _MODELS:
        raise ValueError(
            f" [!] Model {model_name!r} is not ported to tts_tpu_torch yet "
            f"(ported: {sorted(_MODELS)})"
        )
    return _MODELS[name]


def config_from_dict(config_dict: Dict):
    """A ``config.json`` dict → the port's config object for its model."""
    return _load(_entry(config_dict.get("model", ""))[0]).from_dict(config_dict)


def setup_model(config):
    """Config → an (unloaded) model module."""
    return _load(_entry(config.model)[1]).init_from_config(config)
