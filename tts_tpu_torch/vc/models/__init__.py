"""VC model registry of the port (port of ``tts_tpu/vc/models/__init__.py``;
reference ``TTS/vc/models/__init__.py``)."""

from __future__ import annotations


def setup_model(config):
    """A VC config → its (unloaded) host wrapper; only FreeVC exists."""
    if config.model.lower() == "freevc":
        from tts_tpu_torch.vc.models.freevc import FreeVC

        return FreeVC.init_from_config(config)
    raise ModuleNotFoundError(f" [!] Unknown VC model {config.model!r}")
