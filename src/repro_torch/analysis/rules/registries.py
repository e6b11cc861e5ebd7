"""``registry-completeness``: everything registered is everywhere it
must be — the bench matrix and the test suite.

The bench matrix of the port is ``chip_smoke.py`` (role "bench") until
the port has a benchmark of its own; its test suite is
``tests/test_torch_*.py``. The port's pluggable axes (strategies, detectors, workloads, traffic
autoscalers, orchestrator fault injectors) plus the scenario-family
registry promise that "registering
once makes it appear everywhere". The *registries* deliver half of that (``names()``
iteration is dynamic); this rule proves the other half statically:

* every ``@register("<name>")``-ed strategy/detector/workload/autoscaler/injector
  in source modules is **benched** — the benchmark either iterates that axis's
  ``names()`` (resolved through its imports) or names it literally — and
  **tested** — some test module iterates the axis's ``names()`` or names
  it literally;
* every scenario factory (a function building ``ScenarioSpec(name=...)``
  in the module that defines the scenario ``register`` loop) is actually
  registered — a factory written but left out of the registration loop
  is invisible everywhere;
* scenario family names are benched and tested by the same criterion.

Registrations inside test modules (throwaway strategies registered in
test bodies) are exempt — they are supposed to be local.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import (
    ModuleSource,
    Project,
    call_name,
    dotted,
    str_arg,
)
from repro_torch.analysis.registry import register

#: axis key -> dotted-path fragment that identifies its registry
AXES = {
    "strategies": ".strategies",
    "detectors": ".telemetry",
    "workloads": ".workloads",
    "scenarios": ".scenarios",
    "autoscalers": ".traffic",
    "injectors": ".orchestrator",
}


def _axis_of(dotted_path: Optional[str]) -> Optional[str]:
    if not dotted_path:
        return None
    for axis, frag in AXES.items():
        if frag in "." + dotted_path or dotted_path.startswith(frag.lstrip(".")):
            return axis
    return None


def _decorator_registrations(mod: ModuleSource) -> List[Tuple[str, str, int]]:
    """``(axis, name, lineno)`` for every ``@register("<name>")`` class in
    the module, with the axis resolved through the decorator's import."""
    aliases = mod.import_aliases()
    out: List[Tuple[str, str, int]] = []
    for node in mod.nodes():
        if not isinstance(node, ast.ClassDef):
            continue
        for deco in node.decorator_list:
            if not isinstance(deco, ast.Call):
                continue
            name = call_name(deco, aliases)
            if not name or name.split(".")[-1] != "register":
                continue
            axis = _axis_of(name)
            reg = str_arg(deco, 0, keyword="name")
            if axis and reg:
                out.append((axis, reg, deco.lineno))
    return out


def _scenario_registrations(mod: ModuleSource) -> Optional[Dict]:
    """Static model of a scenario-registry module: factory functions
    returning ``ScenarioSpec(name="...")`` plus the names iterated by the
    ``for _f in (...): register(_f().name, _f)`` loop. Returns None when
    the module has no such loop."""
    factories: Dict[str, Tuple[str, int]] = {}  # func name -> (scenario, line)
    for node in mod.nodes():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = dotted(sub.func)
                if callee and callee.split(".")[-1] == "ScenarioSpec":
                    scen = str_arg(sub, 0, keyword="name")
                    if scen:
                        factories[node.name] = (scen, node.lineno)
    registered_factories: Set[str] = set()
    has_loop = False
    for node in mod.nodes():
        if isinstance(node, ast.For) and isinstance(node.iter, (ast.Tuple, ast.List)):
            body_calls = [
                c
                for b in node.body
                for c in ast.walk(b)
                if isinstance(c, ast.Call)
                and dotted(c.func)
                and dotted(c.func).split(".")[-1] == "register"
            ]
            if not body_calls:
                continue
            has_loop = True
            for e in node.iter.elts:
                if isinstance(e, ast.Name):
                    registered_factories.add(e.id)
        elif isinstance(node, ast.Call):
            callee = dotted(node.func)
            if callee and callee.split(".")[-1] == "register":
                scen = str_arg(node, 0, keyword="name")
                if scen:  # direct register("name", factory) form
                    registered_factories.add(scen)
    if not factories or not has_loop:
        return None
    return {"factories": factories, "registered": registered_factories}


def _names_axes_called(mod: ModuleSource) -> Set[str]:
    """Axes whose registry ``names()`` the module iterates, resolved
    through its imports (``strategy_names()``, ``detectors.names()``,
    ``registry.names()`` where ``registry`` is the scenarios registry...)."""
    aliases = mod.import_aliases()
    out: Set[str] = set()
    for node in mod.nodes():
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node, aliases)
        if not name:
            continue
        leaf = name.split(".")[-1]
        if leaf != "names" and not leaf.endswith("_names"):
            continue
        axis = _axis_of(name)
        if axis:
            out.add(axis)
    return out


@register("registry-completeness")
class RegistryCompletenessRule(Rule):
    description = (
        "every registered strategy/detector/workload/autoscaler/injector/"
        "scenario reaches the bench matrix and at least one test; every "
        "scenario factory is registered"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        # name -> (axis, module, lineno)
        registered: List[Tuple[str, str, ModuleSource, int]] = []
        for mod in project.by_role("src"):
            for axis, name, line in _decorator_registrations(mod):
                registered.append((axis, name, mod, line))
            scen = _scenario_registrations(mod)
            if scen:
                for fname, (scen_name, line) in scen["factories"].items():
                    if (
                        fname not in scen["registered"]
                        and scen_name not in scen["registered"]
                    ):
                        anchor = ast.Module(body=[], type_ignores=[])
                        anchor.lineno = line
                        out.append(
                            mod.finding(
                                self.name, anchor, fname,
                                f"scenario factory {fname}() builds "
                                f"{scen_name!r} but is missing from the "
                                f"registration loop — the family is invisible "
                                f"to campaigns, Monte-Carlo, and the bench",
                            )
                        )
                    else:
                        registered.append(("scenarios", scen_name, mod, line))

        bench_mods = project.by_role("bench")
        test_mods = project.by_role("test")
        bench_axes: Set[str] = set()
        bench_strings: Set[str] = set()
        for bm in bench_mods:
            bench_axes |= _names_axes_called(bm)
            bench_strings |= project.string_literals(bm)
        test_axes: Set[str] = set()
        test_strings: Set[str] = set()
        for tm in test_mods:
            test_axes |= _names_axes_called(tm)
            test_strings |= project.string_literals(tm)

        for axis, name, mod, line in registered:
            anchor = ast.Module(body=[], type_ignores=[])
            anchor.lineno = line
            if bench_mods and axis not in bench_axes and name not in bench_strings:
                out.append(
                    mod.finding(
                        self.name, anchor, name,
                        f"registered {axis[:-1] if axis.endswith('s') else axis} "
                        f"{name!r} never reaches the bench matrix — no bench "
                        f"module iterates the {axis} registry names() or names "
                        f"it literally",
                    )
                )
            if test_mods and axis not in test_axes and name not in test_strings:
                out.append(
                    mod.finding(
                        self.name, anchor, name,
                        f"registered {axis[:-1] if axis.endswith('s') else axis} "
                        f"{name!r} appears in no test module — no sweep over "
                        f"the {axis} registry names() and no literal mention",
                    )
                )
        return out
