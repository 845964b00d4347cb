"""Scenario registry (ref: scenario registry in env/scenario.hpp:43-84 and
scenariosGlobalInit, scenarios/include/scenarios/init.hpp:26-57).

Names are case-insensitive, matching the reference's toLower registry keys.
"""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, type] = {}


def register_scenario(name: str, cls: type) -> None:
    _REGISTRY[name.casefold()] = cls


def make_scenario(name: str, **kwargs):
    key = name.casefold()
    if key not in _REGISTRY:
        _ensure_builtin()
    if key not in _REGISTRY:
        raise KeyError(
            f"Unknown scenario {name!r}. Registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[key](**kwargs)


def registered_scenarios():
    _ensure_builtin()
    return sorted(_REGISTRY)


_BUILTIN_LOADED = False


def _ensure_builtin() -> None:
    """Import built-in scenario modules (they self-register on import)."""
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    _BUILTIN_LOADED = True
    from megaverse_tpu_torch.scenarios import (  # noqa: F401
        box_a_gone,
        collect,
        empty,
        football,
        hex,
        obstacles,
        rearrange,
        sokoban,
        tower_building,
    )
