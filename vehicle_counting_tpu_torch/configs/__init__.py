"""YAML configuration system.

Same two-file surface as the reference (configs/configs.py:3-46,
configs/configs.yaml, configs/cam_configs.yaml): a `settings:`-rooted YAML
becomes an attribute-access object whose missing attributes read as None,
plus a dict-override helper.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


class Config:
    """Attribute-style view over the `settings:` mapping of a YAML file.

    Mirrors the reference Config contract (configs/configs.py:3-29):
      - `Config(path)` loads YAML and exposes `settings` keys as attributes;
      - missing attributes return None instead of raising;
      - nested dicts stay plain dicts (the reference indexes them).
    """

    def __init__(self, yaml_path: Optional[str] = None, _settings: Optional[Dict[str, Any]] = None):
        if _settings is not None:
            settings = dict(_settings)
        else:
            if yaml_path is None:
                raise ValueError("Config requires a yaml_path or a settings dict")
            with open(yaml_path, "r") as f:
                doc = yaml.safe_load(f) or {}
            settings = doc.get("settings", doc) or {}
        object.__setattr__(self, "_settings", settings)
        object.__setattr__(self, "_yaml_path", yaml_path)

    # -- mapping-ish access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._settings.get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._settings[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._settings[name]

    def __contains__(self, name: str) -> bool:
        return name in self._settings

    def get(self, name: str, default: Any = None) -> Any:
        return self._settings.get(name, default)

    def keys(self):
        return self._settings.keys()

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._settings)

    def __repr__(self) -> str:
        lines = ["Config("]
        for k, v in self._settings.items():
            lines.append(f"  {k}: {v!r}")
        lines.append(")")
        return "\n".join(lines)


def config_from_dict(config: Config, overrides: Dict[str, Any]) -> Config:
    """Return a copy of `config` with `overrides` applied on top.

    Reference contract: configs/configs.py:32-37.
    """
    merged = config.to_dict()
    merged.update(overrides)
    return Config(_settings=merged)


def default_config() -> Config:
    """The packaged model/pipeline defaults (mirrors configs/configs.yaml)."""
    return Config(os.path.join(_PKG_DIR, "configs.yaml"))


def default_cam_config() -> Config:
    """The packaged per-camera tracking defaults (mirrors cam_configs.yaml)."""
    return Config(os.path.join(_PKG_DIR, "cam_configs.yaml"))
