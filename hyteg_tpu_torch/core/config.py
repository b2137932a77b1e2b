"""Typed run configuration (copy of hyteg_tpu/core/config.py: host
Python, no array library).

Analog of the reference's waLBerla .prm config blocks
(reference: tutorials/FA.01_GeometricMultigrid.cpp:196-208 — blocks of
key/value pairs read at startup). Here: nested dataclass-style configs
loadable from JSON/TOML, with dotted-path overrides (CLI friendly).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class Parameters:
    """Generic parameter block: attribute access over a nested dict."""

    _data: dict

    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            v = data[key]
            return Parameters(v) if isinstance(v, dict) else v
        raise AttributeError(key)

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def block(self, key: str) -> "Parameters":
        return Parameters(self._data[key])

    def as_dict(self) -> dict:
        return self._data

    def with_overrides(self, overrides: dict[str, Any]) -> "Parameters":
        """Apply dotted-path overrides: {"solver.max_level": 6}."""
        import copy

        data = copy.deepcopy(self._data)
        for path, value in overrides.items():
            node = data
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return Parameters(data)


def load_config(path: str) -> Parameters:
    if path.endswith(".json"):
        with open(path) as f:
            return Parameters(json.load(f))
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return Parameters(tomllib.load(f))
    raise ValueError(f"unsupported config format: {path}")


def from_dict(d: dict) -> Parameters:
    return Parameters(d)
