"""Checkpoint and config files (port of ``tts_tpu/utils/io.py``; reference
``TTS/utils/io.py``).

The JAX package writes one flax msgpack file; the port writes one
``torch.save`` file holding a dict:

- ``"model"``: the generator's ``state_dict``, so that
  ``Vits.load_checkpoint`` (and the ``Synthesizer``) read the file as it
  stands;
- ``"discriminator"``: the discriminator's ``state_dict`` (GAN models);
- ``"optimizer"``: each parameter group's optimizer state
  (``OptimizerState.state_dict``);
- ``"config"``: the config as a dict;
- ``"meta"``: ``step``, ``best_loss`` and ``epochs_done``.

Every tensor is saved on the CPU, and the file holds only tensors and plain
types, so it loads under ``torch.load(..., weights_only=True)``.

Paths may be remote URLs (``s3://``, ``gs://``, ``hf://``, ``http(s)://``,
``memory://`` …): they go through fsspec, imported only then, with remote
reads optionally cached to ``~/.cache/tts_tpu`` (reference ``load_fsspec``,
``TTS/utils/io.py:27-54``). Plain local paths never touch fsspec.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_full", "save_config",
           "load_config_dict"]


def _is_remote(path) -> bool:
    p = str(path)
    return "://" in p and not p.startswith("file://")


def _open(path, mode: str, cache: bool = False):
    """Local paths → builtin ``open``; URLs → fsspec (optionally through a
    local file cache for reads, like the reference ``load_fsspec``)."""
    if not _is_remote(path):
        if "b" in mode:
            return open(path, mode)
        return open(path, mode, encoding="utf-8")
    import fsspec

    if cache and "r" in mode:
        cache_dir = os.path.join(os.path.expanduser("~"), ".cache", "tts_tpu", "fsspec")
        return fsspec.open(f"filecache::{path}", mode,
                           filecache={"cache_storage": cache_dir}).open()
    return fsspec.open(path, mode).open()


def _to_cpu(tree):
    """Tensors moved to the CPU (detached), containers kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, model: Dict[str, torch.Tensor], config=None,
                    meta: Optional[Dict] = None, discriminator: Optional[Dict] = None,
                    optimizer: Optional[Dict] = None) -> None:
    """Write one checkpoint file (see the module's docstring): ``model`` and
    ``discriminator`` are ``state_dict``s, ``optimizer`` a dict of each
    group's optimizer state, so ``--continue_path`` resumes the moments, the
    schedule's count and the accumulation buffer exactly."""
    payload = {
        "model": _to_cpu(model),
        "config": config.to_dict() if config is not None and hasattr(config, "to_dict")
        else (config or {}),
        "meta": dict(meta or {}),
    }
    if discriminator is not None:
        payload["discriminator"] = _to_cpu(discriminator)
    if optimizer is not None:
        payload["optimizer"] = _to_cpu(optimizer)
    if not _is_remote(path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wb") as f:
        torch.save(payload, f)


def load_checkpoint_full(path: str, cache: bool = True) -> Dict:
    """The checkpoint's whole dict (``model``, ``config``, ``meta`` and, where
    saved, ``discriminator`` and ``optimizer``), tensors on the CPU."""
    if not _is_remote(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with _open(path, "rb", cache=cache) as f:
        data = f.read()
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, cache: bool = True) -> Tuple[Any, Dict, Dict]:
    """``(model state_dict, config dict, meta)``. Remote URLs are cached
    locally on first read when ``cache`` (reference ``io.py:27``
    ``load_fsspec``)."""
    payload = load_checkpoint_full(path, cache=cache)
    return payload["model"], payload.get("config", {}), payload.get("meta", {})


def save_config(config, path: str) -> None:
    with _open(path, "w") as f:
        json.dump(config.to_dict() if hasattr(config, "to_dict") else config, f, indent=2,
                  default=str)


def load_config_dict(path: str) -> Dict:
    with _open(path, "r") as f:
        return json.load(f)
