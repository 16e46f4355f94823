"""Lazy re-exports for the package `__init__`s.

Each package names what it re-exports, by submodule, and imports a
submodule only when one of its names is first read (a module `__getattr__`,
as the JAX package's top level does for `CountingPipeline`). So importing a
package stays cheap, and `ops/__init__.py`, whose `true_div` every op
module imports, imports none of them.
"""

from __future__ import annotations

import importlib
import sys
import types
from typing import Dict, Sequence


class _Package(types.ModuleType):
    def __setattr__(self, name, value):
        # Loading a submodule binds it on its package. Where a re-exported
        # name is also a submodule's (`ops.letterbox`, the function), the
        # name keeps meaning the re-exported object, as in the JAX package.
        if isinstance(value, types.ModuleType) and name in self._lazy_exports:
            return
        super().__setattr__(name, value)


def lazy_exports(package: str, exports: Dict[str, Sequence[str]]):
    """(__all__, __getattr__) for `package`, re-exporting
    {submodule: names}: each name is the submodule's own object."""
    where = {name: sub for sub, names in exports.items() for name in names}
    module = sys.modules[package]

    def __getattr__(name):
        sub = where.get(name)
        if sub is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{sub}"), name)
        module.__dict__[name] = value
        return value

    module._lazy_exports = where
    module.__class__ = _Package
    return list(where), __getattr__
