"""Injector registry: the single authority on which fault injectors exist.

Sixth registry-backed axis, same idiom as ``strategies/registry.py``,
``telemetry/registry.py``, ``workloads/registry.py`` and
``traffic/registry.py``: registration order is preserved (the
reference's, the row order of its benchmark's orchestrator matrix), the
built-in injectors load lazily, and names and aliases share one
resolution namespace.

    from repro_torch.orchestrator.injector import Injector
    from repro_torch.orchestrator.registry import register

    @register("my_chaos")
    class MyChaos(Injector):
        ...
"""
from __future__ import annotations

from typing import Dict, List

_REGISTRY: Dict[str, type] = {}
_ALIASES: Dict[str, str] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in injectors self-register on import; load them lazily so
    ``repro_torch.orchestrator.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.orchestrator.injector  # noqa: F401 - registration side effect


def register(name: str, aliases: tuple = (), overwrite: bool = False):
    """Class decorator: ``@register("kill")`` adds the injector under
    ``name`` (and optional ``aliases``) and stamps ``cls.name``."""

    def deco(cls: type) -> type:
        from repro_torch.orchestrator.injector import Injector

        if not (isinstance(cls, type) and issubclass(cls, Injector)):
            raise TypeError(f"{cls!r} is not an Injector subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite:
            taken = set(_REGISTRY) | set(_ALIASES)
            for n in (name, *aliases):
                if n in taken:
                    raise KeyError(f"injector name/alias {n!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def unregister(name: str):
    """Remove an injector (tests registering throwaway chaos policies)."""
    _REGISTRY.pop(name, None)
    for a in [a for a, n in _ALIASES.items() if n == name]:
        _ALIASES.pop(a)


def get(name: str, **cfg):
    """Instantiate a registered injector. ``cfg`` is passed to the
    constructor."""
    return get_class(name)(**cfg)


def names() -> List[str]:
    """Canonical injector names, in registration (= matrix row) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def get_class(name: str) -> type:
    """Resolve a name or alias to its injector class."""
    _ensure_builtin()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown injector {name!r}; have {names()} (aliases: {sorted(_ALIASES)})"
        ) from None
