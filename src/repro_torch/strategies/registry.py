"""Strategy registry: the single authority on which FT approaches exist.

``core/sim.py`` (Tables 1-2), ``core/trainer.py`` (live training),
``scenarios/engine.py`` (campaigns) and the benchmark reports all iterate
this registry — registering a strategy in ONE place makes it appear
everywhere at once.

Registration order is preserved: it is the row order of the table
benchmarks, so the seven built-ins keep the seed CSVs byte-identical and
new strategies append after them.

    from repro_torch.strategies import FaultToleranceStrategy, register

    @register("my_strategy")
    class MyStrategy(FaultToleranceStrategy):
        ...
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from repro_torch.strategies.base import FaultToleranceStrategy

_REGISTRY: Dict[str, Type[FaultToleranceStrategy]] = {}
_ALIASES: Dict[str, str] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in adapters self-register on import; load them lazily so
    ``repro_torch.strategies.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.strategies.builtin  # noqa: F401 - registration side effect


def register(name: str, aliases: tuple = (), overwrite: bool = False):
    """Class decorator: ``@register("agent")`` adds the strategy under
    ``name`` (and optional ``aliases``) and stamps ``cls.name``."""

    def deco(cls: Type[FaultToleranceStrategy]) -> Type[FaultToleranceStrategy]:
        if not (isinstance(cls, type) and issubclass(cls, FaultToleranceStrategy)):
            raise TypeError(f"{cls!r} is not a FaultToleranceStrategy subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite:
            # names and aliases share one resolution namespace: a collision
            # on either side would silently reroute or orphan a strategy
            taken = set(_REGISTRY) | set(_ALIASES)
            for n in (name, *aliases):
                if n in taken:
                    raise KeyError(f"strategy name/alias {n!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def unregister(name: str):
    """Remove a strategy (tests registering throwaway strategies)."""
    _REGISTRY.pop(name, None)
    for a in [a for a, n in _ALIASES.items() if n == name]:
        _ALIASES.pop(a)


def get(name: str, **cfg) -> FaultToleranceStrategy:
    """Instantiate a registered strategy. ``cfg`` is passed to the
    constructor (e.g. ``placement="partition-aware"``)."""
    return get_class(name)(**cfg)


def names() -> List[str]:
    """Canonical strategy names, in registration (= table row) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def get_class(name: str) -> Type[FaultToleranceStrategy]:
    """Resolve a name or alias to its strategy class."""
    _ensure_builtin()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; have {names()} (aliases: {sorted(_ALIASES)})"
        ) from None
