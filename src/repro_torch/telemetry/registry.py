"""Detector registry: the single authority on which detectors exist.

Same idiom as ``strategies/registry.py``: registration order is preserved
(it is the row order of the benchmark's per-detector precision/recall
report), the built-in adapters load lazily, and names and aliases share
one resolution namespace.

    from repro_torch.telemetry import Detector, register

    @register("my_detector")
    class MyDetector(Detector):
        ...
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.telemetry.detector import Detector

_REGISTRY: Dict[str, Type[Detector]] = {}
_ALIASES: Dict[str, str] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in adapters self-register on import; load them lazily so
    ``repro_torch.telemetry.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.telemetry.builtin  # noqa: F401 - registration side effect


def register(name: str, aliases: tuple = (), overwrite: bool = False):
    """Class decorator: ``@register("oracle")`` adds the detector under
    ``name`` (and optional ``aliases``) and stamps ``cls.name``."""

    def deco(cls: Type[Detector]) -> Type[Detector]:
        if not (isinstance(cls, type) and issubclass(cls, Detector)):
            raise TypeError(f"{cls!r} is not a Detector subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite:
            taken = set(_REGISTRY) | set(_ALIASES)
            for n in (name, *aliases):
                if n in taken:
                    raise KeyError(f"detector name/alias {n!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def unregister(name: str):
    """Remove a detector (tests registering throwaway detectors)."""
    _REGISTRY.pop(name, None)
    for a in [a for a, n in _ALIASES.items() if n == name]:
        _ALIASES.pop(a)


def get(name: str, **cfg) -> Detector:
    """Instantiate a registered detector. ``cfg`` is passed to the
    constructor (e.g. ``transient_rate=0.1``)."""
    return get_class(name)(**cfg)


def names() -> List[str]:
    """Canonical detector names, in registration (= report row) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def get_class(name: str) -> Type[Detector]:
    """Resolve a name or alias to its detector class."""
    _ensure_builtin()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown detector {name!r}; have {names()} (aliases: {sorted(_ALIASES)})"
        ) from None
