"""Scenario registry of the frozen reference: every module in this folder
that calls `register_scenario` is found by scanning the folder, so a
scenario is added as a new file."""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict

_REGISTRY: Dict[str, type] = {}


def register_scenario(name: str, cls: type) -> None:
    _REGISTRY[name.casefold()] = cls


def make_scenario(name: str, **kwargs):
    if name.casefold() not in _REGISTRY:
        for mod in pkgutil.iter_modules(__path__):
            importlib.import_module(f"{__name__}.{mod.name}")
    if name.casefold() not in _REGISTRY:
        raise KeyError(f"Unknown scenario {name!r}. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name.casefold()](**kwargs)
