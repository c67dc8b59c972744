"""Copied from ``tts_tpu/config/base.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and import paths.

Config base class — a Coqpit-equivalent built on stdlib dataclasses.

The reference uses the external ``coqpit`` package for all of its configs
(see reference ``TTS/config/shared_configs.py``): typed dataclass fields,
JSON round-trip, nested configs, and dotted CLI overrides
(``--coqpit.datasets.0.path ...``).  This module provides the same
capabilities natively so every model/trainer config in this framework is a
plain ``@dataclass`` subclassing :class:`Config`.

Capabilities:
  * ``to_dict`` / ``from_dict`` — recursive (de)serialization of nested
    configs, lists of configs, and plain values.
  * ``to_json`` / ``from_json`` / ``save_json`` / ``load_json``.
  * ``parse_args`` — dotted CLI overrides ``--config.a.b.c value`` and
    list indexing ``--config.datasets.0.path ...`` (reference:
    ``tests/tts_tests/test_vits_train.py:38-47``).
  * attribute-style and dict-style (``cfg["x"]``, ``"x" in cfg``) access.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Union

__all__ = ["Config", "dataclass", "field"]


def _is_config_type(tp) -> bool:
    return isinstance(tp, type) and is_dataclass(tp)


def _unwrap_optional(tp):
    """Return the inner type of Optional[T]/Union[T, None], else tp."""
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _serialize(value: Any) -> Any:
    if is_dataclass(value) and not isinstance(value, type):
        out = {}
        for f in fields(value):
            out[f.name] = _serialize(getattr(value, f.name))
        return out
    if isinstance(value, (list, tuple)):
        return [_serialize(v) for v in value]
    if isinstance(value, dict):
        return {k: _serialize(v) for k, v in value.items()}
    return value


def _deserialize(value: Any, tp) -> Any:
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    if _is_config_type(tp):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return tp.from_dict(value) if hasattr(tp, "from_dict") else tp(**value)
        return value
    origin = typing.get_origin(tp)
    if origin in (list, List):
        (inner,) = typing.get_args(tp) or (Any,)
        if isinstance(value, (list, tuple)):
            return [_deserialize(v, inner) for v in value]
        return value
    if origin in (dict, Dict):
        args = typing.get_args(tp)
        inner = args[1] if len(args) == 2 else Any
        if isinstance(value, dict):
            return {k: _deserialize(v, inner) for k, v in value.items()}
        return value
    if origin in (tuple,):
        if isinstance(value, (list, tuple)):
            return tuple(value)
        return value
    return value


@dataclass
class Config:
    """Base class for all configs (Coqpit-equivalent)."""

    # ---- dict-style access -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        try:
            return hasattr(self, key)
        except Exception:  # pragma: no cover
            return False

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in fields(self)]

    def items(self):
        return [(f.name, getattr(self, f.name)) for f in fields(self)]

    def has(self, key: str) -> bool:
        return key in self.keys()

    # ---- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _serialize(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        """Build from a dict, ignoring unknown keys, recursing into nested configs."""
        kwargs = {}
        cls_fields = {f.name: f for f in fields(cls)}
        hints = typing.get_type_hints(cls)
        for name, f in cls_fields.items():
            if name in data:
                kwargs[name] = _deserialize(data[name], hints.get(name, Any))
        obj = cls(**kwargs)
        return obj

    def update(self, data: Dict[str, Any], allow_new: bool = False) -> None:
        hints = typing.get_type_hints(type(self))
        known = {f.name for f in fields(self)}
        for k, v in data.items():
            if k in known:
                setattr(self, k, _deserialize(v, hints.get(k, Any)))
            elif allow_new:
                setattr(self, k, v)

    def to_json(self, indent: int = 4) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=_json_default)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def save_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load_json(cls, path: str) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    def copy(self) -> "Config":
        return type(self).from_dict(self.to_dict())

    # ---- CLI override parsing ---------------------------------------------
    def parse_args(self, args: List[str], arg_prefix: str = "coqpit") -> List[str]:
        """Apply dotted overrides like ``--coqpit.model_args.hidden 192``.

        Both ``--k v`` and ``--k=v`` forms are accepted.  Returns the list of
        unconsumed argv entries.
        """
        rest: List[str] = []
        i = 0
        prefix = f"--{arg_prefix}."
        while i < len(args):
            a = args[i]
            if a.startswith(prefix):
                body = a[len(prefix):]
                if "=" in body:
                    path, raw = body.split("=", 1)
                    i += 1
                else:
                    path = body
                    if i + 1 >= len(args):
                        raise ValueError(f"missing value for override {a}")
                    raw = args[i + 1]
                    i += 2
                self._apply_override(path.split("."), raw)
            else:
                rest.append(a)
                i += 1
        return rest

    # alias matching coqpit naming
    parse_known_args = parse_args

    def _apply_override(self, path: List[str], raw: str) -> None:
        obj: Any = self
        for key in path[:-1]:
            if key.isdigit():
                obj = obj[int(key)]
            else:
                obj = getattr(obj, key)
        last = path[-1]
        if last.isdigit():
            current = obj[int(last)]
            obj[int(last)] = _coerce(raw, type(current) if current is not None else None)
        else:
            current = getattr(obj, last, None)
            setattr(obj, last, _coerce(raw, type(current) if current is not None else None))

    def check_values(self) -> None:  # hook for subclasses
        pass


def _coerce(raw: str, tp: Optional[type]) -> Any:
    """Parse a CLI string into tp (or guess via JSON)."""
    if tp is bool:
        return raw.lower() in ("1", "true", "yes", "y", "on")
    if tp in (int, float, str) and tp is not None:
        try:
            return tp(raw)
        except ValueError:
            pass
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if is_dataclass(o) and not isinstance(o, type):
        return _serialize(o)
    return str(o)
