"""Workload registry: the single authority on which workload models exist.

Same idiom as ``strategies/registry.py`` and ``telemetry/registry.py``:
registration order is preserved (it is the row order of the benchmark's
per-workload overhead matrix), the built-in models load lazily, and
names and aliases share one resolution namespace.

    from repro_torch.workloads import Workload, register

    @register("my_workload")
    class MyWorkload(Workload):
        ...
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.workloads.base import Workload

_REGISTRY: Dict[str, Type[Workload]] = {}
_ALIASES: Dict[str, str] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in models self-register on import; load them lazily so
    ``repro_torch.workloads.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.workloads.builtin  # noqa: F401 - registration side effect


def register(name: str, aliases: tuple = (), overwrite: bool = False):
    """Class decorator: ``@register("genome_search")`` adds the workload
    under ``name`` (and optional ``aliases``) and stamps ``cls.name``."""

    def deco(cls: Type[Workload]) -> Type[Workload]:
        if not (isinstance(cls, type) and issubclass(cls, Workload)):
            raise TypeError(f"{cls!r} is not a Workload subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite:
            taken = set(_REGISTRY) | set(_ALIASES)
            for n in (name, *aliases):
                if n in taken:
                    raise KeyError(f"workload name/alias {n!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def unregister(name: str):
    """Remove a workload (tests registering throwaway models)."""
    _REGISTRY.pop(name, None)
    for a in [a for a, n in _ALIASES.items() if n == name]:
        _ALIASES.pop(a)


def get(name: str, **cfg) -> Workload:
    """Instantiate a registered workload. ``cfg`` is passed to the
    constructor (e.g. ``arch="gemma-2b"``)."""
    return get_class(name)(**cfg)


def names() -> List[str]:
    """Canonical workload names, in registration (= matrix row) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def get_class(name: str) -> Type[Workload]:
    """Resolve a name or alias to its workload class."""
    _ensure_builtin()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r}; have {names()} (aliases: {sorted(_ALIASES)})"
        ) from None
