"""Rule registry: the single authority on which lint rules exist.

Same idiom as ``strategies/registry.py`` / ``telemetry/registry.py`` /
``workloads/registry.py``: registration order is preserved (it is the
order rules run and report in), the built-in rules load lazily, and a
rule registered anywhere immediately appears in the CLI, the JSON
schema, and ``--list-rules``.

    from repro_torch.analysis import Rule, register

    @register("my-rule")
    class MyRule(Rule):
        description = "one line"
        def check(self, project): ...
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.analysis.base import Rule

_REGISTRY: Dict[str, Type[Rule]] = {}
_builtin_loaded = False


def _ensure_builtin():
    """The built-in rules self-register on import; load them lazily so
    ``repro_torch.analysis.registry`` itself stays import-cycle-free."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        import repro_torch.analysis.rules  # noqa: F401 - registration side effect


def register(name: str, overwrite: bool = False):
    """Class decorator: ``@register("traced-purity")`` adds the rule
    under ``name`` and stamps ``cls.name``."""

    def deco(cls: Type[Rule]) -> Type[Rule]:
        if not (isinstance(cls, type) and issubclass(cls, Rule)):
            raise TypeError(f"{cls!r} is not a Rule subclass")
        _ensure_builtin()  # collisions with built-ins surface eagerly
        if not overwrite and name in _REGISTRY:
            raise KeyError(f"rule name {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def unregister(name: str):
    """Remove a rule (tests registering throwaway rules)."""
    _REGISTRY.pop(name, None)


def get(name: str, **cfg) -> Rule:
    """Instantiate a registered rule."""
    _ensure_builtin()
    try:
        return _REGISTRY[name](**cfg)
    except KeyError:
        raise KeyError(f"unknown rule {name!r}; have {names()}") from None


def names() -> List[str]:
    """Rule names, in registration (= run/report) order."""
    _ensure_builtin()
    return list(_REGISTRY)


def all_rules() -> List[Rule]:
    """One instance of every registered rule, in registration order."""
    _ensure_builtin()
    return [cls() for cls in _REGISTRY.values()]
