"""Autoscaler registry: the single authority on which capacity policies exist.

Fourth registry-backed axis, same idiom as ``strategies/registry.py``,
``telemetry/registry.py`` and ``workloads/registry.py``: registration
order is preserved (it is the row order of the benchmark's traffic
matrix), the built-in policies load lazily, and names and aliases share
one resolution namespace.

    from repro_torch.traffic import Autoscaler, register

    @register("my_policy")
    class MyPolicy(Autoscaler):
        ...
"""
from __future__ import annotations

from typing import Dict, List, Type

_REGISTRY: Dict[str, type] = {}
_ALIASES: Dict[str, str] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in policies self-register on import; load them lazily so
    ``repro_torch.traffic.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.traffic.autoscale  # noqa: F401 - registration side effect


def register(name: str, aliases: tuple = (), overwrite: bool = False):
    """Class decorator: ``@register("shrink_to_fit")`` adds the autoscaler
    under ``name`` (and optional ``aliases``) and stamps ``cls.name``."""

    def deco(cls: type) -> type:
        from repro_torch.traffic.autoscale import Autoscaler

        if not (isinstance(cls, type) and issubclass(cls, Autoscaler)):
            raise TypeError(f"{cls!r} is not an Autoscaler subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite:
            taken = set(_REGISTRY) | set(_ALIASES)
            for n in (name, *aliases):
                if n in taken:
                    raise KeyError(f"autoscaler name/alias {n!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def unregister(name: str):
    """Remove an autoscaler (tests registering throwaway policies)."""
    _REGISTRY.pop(name, None)
    for a in [a for a, n in _ALIASES.items() if n == name]:
        _ALIASES.pop(a)


def get(name: str, **cfg):
    """Instantiate a registered autoscaler. ``cfg`` is passed to the
    constructor."""
    return get_class(name)(**cfg)


def names() -> List[str]:
    """Canonical autoscaler names, in registration (= matrix row) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def get_class(name: str) -> type:
    """Resolve a name or alias to its autoscaler class."""
    _ensure_builtin()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown autoscaler {name!r}; have {names()} (aliases: {sorted(_ALIASES)})"
        ) from None
