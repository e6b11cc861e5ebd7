"""``units-s``: time values carry their unit in the name, and units
never mix silently.

Every billed quantity in the port is seconds, as in the reference; the convention (`lost_s`,
`horizon_s`, `repair_s`, ...) is what lets a reader audit the campaign
arithmetic line by line, and hour-denominated inputs (``period_h``)
exist right alongside. A bare ``delay`` that actually holds seconds, or
a ``+`` between an ``_s`` name and an ``_h`` name, is exactly the class
of bug the convention exists to prevent. Three checks, all heuristic by
design and tuned to fire only on high-confidence shapes:

* **dataclass fields**: an annotated field named by a time word
  (``delay``, ``duration``, ``horizon``, ``period``, ...) or ending in
  ``_time``/``_delay``/etc. without a unit suffix;
* **derived locals**: a local assignment whose target is a bare time
  word while the right-hand side reads an ``_s``-suffixed name, key, or
  attribute — the value is demonstrably seconds, the name hides it;
* **mixed-unit arithmetic**: ``+``/``-`` (and comparisons) between names
  carrying *different* unit suffixes (``_s`` vs ``_h``/``_ms``);
  multiplication/division is exempt — that is how conversions are
  written.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import ModuleSource, Project, dotted
from repro_torch.analysis.registry import register

#: recognised unit suffixes (longest match wins)
UNIT_SUFFIXES = (
    "_per_hour", "_per_s", "_hms", "_ms", "_us", "_ns", "_hz", "_s", "_h",
)
#: bare names that denote a time quantity when unsuffixed
TIME_WORDS = {
    "delay", "duration", "elapsed", "horizon", "interval", "latency",
    "deadline", "timeout", "period", "spread", "every", "heal", "repair",
    "lead", "span",
}
#: field-name endings that denote a time quantity
TIME_ENDINGS = ("_time", "_delay", "_duration", "_timeout", "_interval",
                "_latency", "_deadline", "_period", "_horizon")


def unit_of(name: Optional[str]) -> Optional[str]:
    if not name:
        return None
    leaf = name.split(".")[-1]
    for suf in UNIT_SUFFIXES:
        if leaf.endswith(suf):
            return suf
    return None


def _is_time_name(name: str) -> bool:
    return name in TIME_WORDS or name.endswith(TIME_ENDINGS)


def _reads_seconds(expr: ast.AST) -> Optional[str]:
    """A ``_s``-suffixed source inside the expression (name, attribute,
    or string key like ``p.get("delay_s")``), if any."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and unit_of(node.id) == "_s":
            return node.id
        if isinstance(node, ast.Attribute) and unit_of(node.attr) == "_s":
            return node.attr
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and unit_of(node.value) == "_s"
            and node.value.isidentifier()
        ):
            return node.value
    return None


def _operand_unit(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return unit_of(node.id)
    if isinstance(node, ast.Attribute):
        return unit_of(node.attr)
    return None


def _is_dataclass(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        name = dotted(target)
        if name and name.split(".")[-1] == "dataclass":
            return True
    return False


@register("units-s")
class UnitsRule(Rule):
    description = (
        "time-valued dataclass fields and seconds-derived locals carry the "
        "_s suffix; +/- never mixes different unit suffixes"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.by_role("src"):
            out.extend(self._check_fields(mod))
            out.extend(self._check_locals(mod))
            out.extend(self._check_mixing(mod))
        return out

    def _check_fields(self, mod: ModuleSource) -> List[Finding]:
        out: List[Finding] = []
        for node in mod.nodes():
            if not (isinstance(node, ast.ClassDef) and _is_dataclass(node)):
                continue
            for stmt in node.body:
                if not (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)):
                    continue
                fname = stmt.target.id
                if unit_of(fname) is None and _is_time_name(fname):
                    out.append(
                        mod.finding(
                            self.name, stmt, f"{node.name}.{fname}",
                            f"time-valued dataclass field {fname!r} carries no "
                            f"unit suffix — name it {fname}_s (or the unit it "
                            f"actually holds)",
                        )
                    )
        return out

    def _check_locals(self, mod: ModuleSource) -> List[Finding]:
        out: List[Finding] = []
        for node in mod.nodes():
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            tname = target.id
            if unit_of(tname) is not None or not _is_time_name(tname):
                continue
            src = _reads_seconds(node.value)
            if src is not None:
                out.append(
                    mod.finding(
                        self.name, node, tname,
                        f"local {tname!r} is derived from seconds-valued "
                        f"{src!r} but drops the unit — name it {tname}_s",
                    )
                )
        return out

    def _check_mixing(self, mod: ModuleSource) -> List[Finding]:
        out: List[Finding] = []
        for node in mod.nodes():
            operands = ()
            if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)):
                operands = (node.left, node.right)
            elif isinstance(node, ast.Compare) and len(node.comparators) == 1:
                operands = (node.left, node.comparators[0])
            if not operands:
                continue
            units = [_operand_unit(o) for o in operands]
            if None in units or units[0] == units[1]:
                continue
            # _per_hour vs _s etc. only make sense under * or /; any direct
            # +/-/comparison across suffixes is a unit error
            names = [dotted(o) or "?" for o in operands]
            out.append(
                mod.finding(
                    self.name, node, names[0],
                    f"unit mixing: {names[0]!r} ({units[0]}) combined with "
                    f"{names[1]!r} ({units[1]}) under +/-/comparison — convert "
                    f"explicitly first",
                )
            )
        return out
