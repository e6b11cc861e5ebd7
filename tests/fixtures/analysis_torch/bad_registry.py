"""Fixture: a scenario factory left out of the registration loop:
``_orphan`` builds a ScenarioSpec but the ``for _f in (...)`` loop never
registers it, so the family is invisible to campaigns, the fold and
``chip_smoke.py``."""

_REGISTRY = {}


class ScenarioSpec:
    def __init__(self, name, **kw):
        self.name = name


def register(name, factory):
    _REGISTRY[name] = factory


def _storm():
    return ScenarioSpec(name="storm")


def _orphan():
    return ScenarioSpec(name="orphan")


for _f in (_storm,):
    register(_f().name, _f)
