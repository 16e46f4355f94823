"""Name -> factory registry (reference: utilities/getter.py:9-15 role).

The port's own copy of `vehicle_counting_tpu/utils/registry.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_instance(config, **kwargs):
    """Instantiate by config['name'] with config['args'] (getter.py contract)."""
    name = config["name"] if isinstance(config, dict) else config.name
    args = (config.get("args") if isinstance(config, dict) else getattr(config, "args", None)) or {}
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} not registered; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**{**args, **kwargs})
