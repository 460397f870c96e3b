"""Generic config machinery: YAML !include, dataclass binding, dot-overrides.

A copy of intact_tpu/config/core.py. Supports the config layout
(`config/train/*.yaml` pulling model JSONs via `!include ../models/x.json`,
any field overridable on the CLI as `--n_updates 3`). PyYAML is imported
only by `load_yaml`, so importing the package and applying CLI overrides
(parsed as JSON, else kept as strings) do not need it.
"""

from __future__ import annotations

import dataclasses
import json
import types
import typing
from pathlib import Path
from typing import Any, get_args, get_origin


# ---------------------------------------------------------------------------
# YAML with !include
# ---------------------------------------------------------------------------

def _include_loader():
    """SafeLoader + `!include rel/path.{yaml,json}` resolved against the
    including file's directory."""
    import yaml

    class IncludeLoader(yaml.SafeLoader):
        pass

    def include(loader: IncludeLoader, node: yaml.Node):
        base = Path(loader.name).parent if loader.name else Path.cwd()
        path = (base / Path(loader.construct_scalar(node))).resolve()
        if path.suffix == ".json":
            with open(path) as f:
                return json.load(f)
        return _load(IncludeLoader, path)

    IncludeLoader.add_constructor("!include", include)
    return IncludeLoader


def _load(loader_cls, path: Path):
    loader = loader_cls(path.read_text())
    loader.name = str(path)
    try:
        return loader.get_single_data()
    finally:
        loader.dispose()


def load_yaml(path: str | Path) -> dict:
    return _load(_include_loader(), Path(path)) or {}


# ---------------------------------------------------------------------------
# dataclass <-> dict binding
# ---------------------------------------------------------------------------

def _unwrap_optional(tp):
    origin = get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: Any, tp) -> Any:
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    origin = get_origin(tp)
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = get_args(tp)
        if origin is tuple:
            if len(args) == 2 and args[1] is Ellipsis:
                return tuple(_coerce(v, args[0]) for v in value)
            if args:
                return tuple(_coerce(v, a) for v, a in zip(value, args))
            return tuple(value)
        elem = args[0] if args else None
        return [_coerce(v, elem) if elem else v for v in value]
    if tp is Path:
        return Path(value)
    if tp in (int, float, bool, str) and not isinstance(value, tp):
        if tp is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return tp(value)
    return value


def from_dict(cls, data: dict):
    """Bind a plain dict onto a dataclass tree (unknown keys rejected)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        kwargs[name] = _coerce(value, _resolve_type(cls, fields[name]))
    return cls(**kwargs)


def _resolve_type(cls, field: dataclasses.Field):
    hints = typing.get_type_hints(cls)
    return hints.get(field.name, field.type)


def to_dict(cfg) -> dict:
    """Dataclass tree -> plain JSON-serializable dict."""

    def convert(v):
        if dataclasses.is_dataclass(v):
            return {f.name: convert(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [convert(x) for x in v]
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, dict):
            return {k: convert(x) for k, x in v.items()}
        return v

    return convert(cfg)


# ---------------------------------------------------------------------------
# CLI overrides
# ---------------------------------------------------------------------------

def apply_overrides(data: dict, overrides: dict[str, str]) -> dict:
    """Apply {"a.b.c": "value"} onto a nested dict. A value is parsed as JSON
    where it is JSON (numbers, true/false, null, lists), else kept as a
    string; from_dict then coerces it to the field's type."""
    out = json.loads(json.dumps(data, default=str))  # deep copy
    for dotted, raw in overrides.items():
        keys = dotted.split(".")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _parse_value(raw) if isinstance(raw, str) else raw
    return out


def _parse_value(raw: str):
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def parse_cli(argv: list[str]) -> tuple[str | None, dict[str, str]]:
    """argv -> (config_path, {dotted_key: raw_value}).

    Accepts `--config_path x.yaml --n_updates 3 --data.backend synthetic`.
    """
    config_path = None
    overrides: dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"Expected --key, got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"Missing value for --{key}")
            value = argv[i + 1]
            i += 1
        if key == "config_path":
            config_path = value
        else:
            overrides[key] = value
        i += 1
    return config_path, overrides
