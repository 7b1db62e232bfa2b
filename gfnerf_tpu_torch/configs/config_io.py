"""Config JSON round-trip and dotted-path overrides.

Port of ``gfnerf_tpu/configs/config_io.py``: configs are plain nested
dataclasses; ``config_to_json`` / ``config_from_json`` give the
reproducible-eval round trip (the JAX package writes the same plain dict as
YAML, which needs a package the port does not depend on), and
``apply_override`` implements the CLI's ``a.b.c=value`` overrides.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, List, get_args, get_origin

_PACKAGE = "gfnerf_tpu_torch."


def _to_plain(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__dataclass__": f"{type(obj).__module__}.{type(obj).__qualname__}",
            **{f.name: _to_plain(getattr(obj, f.name))
               for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    if isinstance(obj, tuple):
        return {"__tuple__": [_to_plain(x) for x in obj]}
    if isinstance(obj, list):
        return [_to_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


def _from_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__path__" in obj:
            return Path(obj["__path__"])
        if "__tuple__" in obj:
            return tuple(_from_plain(x) for x in obj["__tuple__"])
        if "__dataclass__" in obj:
            modname, _, qual = obj["__dataclass__"].rpartition(".")
            if not modname.startswith(_PACKAGE):
                raise ValueError(f"config class {obj['__dataclass__']!r} is "
                                 f"not one of {_PACKAGE[:-1]}'s")
            cls = getattr(importlib.import_module(modname), qual)
            kwargs = {k: _from_plain(v) for k, v in obj.items()
                      if k != "__dataclass__"}
            # tolerate removed/renamed fields across versions
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in kwargs.items() if k in names})
        return {k: _from_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_plain(x) for x in obj]
    return obj


def config_to_json(config: Any) -> str:
    return json.dumps(_to_plain(config), indent=2)


def config_from_json(text: str) -> Any:
    return _from_plain(json.loads(text))


def _number(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def _coerce(value: str, annotation) -> Any:
    origin = get_origin(annotation)
    if origin is not None:
        args = [a for a in get_args(annotation) if a is not type(None)]
        if origin in (tuple, list):
            elt = args[0] if args else None
            ctor = tuple if origin is tuple else list
            return ctor(
                _coerce(v, elt) if elt is not None else _number(v)
                for v in value.split(","))
        if args:
            return _coerce(value, args[0])
    if annotation in (tuple, list):
        ctor = tuple if annotation is tuple else list
        return ctor(_number(v) for v in value.split(","))
    if annotation in (int, "int"):
        return int(value)
    if annotation in (float, "float"):
        return float(value)
    if annotation in (bool, "bool"):
        return value.lower() in ("1", "true", "yes", "on")
    if annotation in (Path, "Path", "pathlib.Path"):
        return Path(value)
    return value


def apply_override(config: Any, dotted: str, value: str):
    """Set config.<a>.<b>.<c> = coerced value; raises on unknown keys."""
    parts = dotted.replace("-", "_").split(".")
    obj = config
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise AttributeError(f"no config field {dotted!r} (at {p!r})")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"no config field {dotted!r} (at {leaf!r})")
    ann = None
    for f in dataclasses.fields(obj):
        if f.name == leaf:
            ann = f.type
            break
    cur = getattr(obj, leaf)
    if ann is None:
        ann = type(cur)
    if isinstance(ann, str):
        # from __future__ annotations: resolve a few common names
        ann = {"int": int, "float": float, "bool": bool, "str": str,
               "Path": Path, "Optional[Path]": Path, "Optional[int]": int,
               "Optional[str]": str, "Optional[float]": float,
               "Optional[List[float]]": List[float],
               "tuple": tuple}.get(ann, type(cur) if cur is not None else str)
    setattr(obj, leaf, _coerce(value, ann))
