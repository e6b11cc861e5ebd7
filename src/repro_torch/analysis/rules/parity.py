"""``parity-coverage``: every DSL process kind and every ``TraceEvent``
kind is threaded through all of its consumer sites.

The engine≡fold guarantee (the port's torch replay fold against its
``CampaignEngine``) is only as strong as its coverage: a process kind
that generates events but is never exercised by a scenario family, or a
trace-event kind the engine emits but the fold's reconstruction never
produces, is exactly the silent drift the differential tests can't see. This rule cross-references the two authoritative kind lists against
their handler sites, statically:

**process kinds** — the ``PROCESS_KINDS`` tuple (``scenarios/spec.py``):

  * *dispatch*: each kind must appear in a comparison inside the module
    that defines the tuple (the ``_gen``/timeline dispatch — a kind with
    no dispatch arm silently generates nothing);
  * *families*: each kind must be constructed by at least one
    ``FailureProcessSpec("<kind>", ...)`` call somewhere in the project
    (the registered scenario families and/or tests);
  * *tests*: when test modules are in the scanned set (the port's
    ``tests/test_torch_*.py``), each kind must be named in at least one
    of them.

**trace-event kinds** — the ``_KIND_ORDER`` table (``obs/trace.py``):

  * *engine side*: each kind must be emitted (``recorder.emit(t, "<kind>"
    ...)`` or ``TraceEvent.make(t, "<kind>", ...)``) outside the fold's
    reconstruction — the live engine/trainer emit sites plus the shared
    ``schedule_events`` helper;
  * *fold side*: each kind must be emitted inside ``reconstruct_traces``
    or ``schedule_events`` — otherwise the timeline rebuilt from the
    fold's records can never contain it and event-level parity is
    unprovable.

Kinds that are engine-only by design (e.g. trainer-side ``rebalance``)
carry a ``# repro: ignore[parity-coverage]`` on their ``_KIND_ORDER``
line — the suppression is the documentation.
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
    enclosing_functions,
    str_arg,
)
from repro_torch.analysis.registry import register

#: functions whose emits count as the fold-side producer
FOLD_SIDE_FUNCS = {"reconstruct_traces", "schedule_events"}
#: functions whose emits count for BOTH sides (static-timeline rows are
#: shared by construction)
SHARED_FUNCS = {"schedule_events"}


def _const_str_elts(node: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """``[(value, lineno)]`` when node is a tuple/list of str constants."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for e in node.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.append((e.value, e.lineno))
    return out


def _const_str_keys(node: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """``[(key, lineno)]`` when node is a dict with str-constant keys."""
    if not isinstance(node, ast.Dict):
        return None
    out = []
    for k in node.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        out.append((k.value, k.lineno))
    return out


def _assignment(mod: ModuleSource, target_name: str) -> Optional[ast.Assign]:
    for node in mod.nodes():
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == target_name:
                    return node
    return None


def _comparison_strings(mod: ModuleSource) -> Set[str]:
    """String constants used in any comparison (``==``, ``!=``, ``in``),
    including membership tuples — the dispatch arms."""
    out: Set[str] = set()
    for node in mod.nodes():
        if not isinstance(node, ast.Compare):
            continue
        for side in (node.left, *node.comparators):
            if isinstance(side, ast.Constant) and isinstance(side.value, str):
                out.add(side.value)
            elif isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                for e in side.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        out.add(e.value)
    return out


def _emitted_kinds(mod: ModuleSource) -> List[Tuple[str, Optional[str]]]:
    """``(kind, enclosing function)`` for every trace-event emission:
    ``X.emit(t, "<kind>", ...)`` and ``TraceEvent.make(t, "<kind>", ...)``."""
    encl = enclosing_functions(mod.tree)
    out: List[Tuple[str, Optional[str]]] = []
    for node in mod.nodes():
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        leaf = name.split(".")[-1]
        if leaf == "emit" or name.endswith("TraceEvent.make"):
            kind = str_arg(node, 1, keyword="kind")
            if kind is not None:
                out.append((kind, encl.get(node)))
    return out


@register("parity-coverage")
class ParityCoverageRule(Rule):
    description = (
        "every PROCESS_KINDS entry is dispatched, exercised by a scenario "
        "family, and tested; every _KIND_ORDER trace kind has both an "
        "engine-side and a fold-side producer"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        out.extend(self._check_process_kinds(project))
        out.extend(self._check_trace_kinds(project))
        return out

    # ----------------------------------------------------- process kinds
    def _check_process_kinds(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            assign = _assignment(mod, "PROCESS_KINDS")
            if assign is None:
                continue
            kinds = _const_str_elts(assign.value)
            if not kinds:
                continue
            dispatched = _comparison_strings(mod)
            constructed = self._constructed_process_kinds(project)
            test_mods = project.by_role("test")
            test_strings: Set[str] = set()
            for tm in test_mods:
                test_strings |= project.string_literals(tm)
            for kind, line in kinds:
                anchor = ast.Module(body=[], type_ignores=[])
                anchor.lineno = line  # anchor findings at the tuple entry
                if kind not in dispatched:
                    out.append(
                        mod.finding(
                            self.name, anchor, kind,
                            f"process kind {kind!r} is declared in PROCESS_KINDS "
                            f"but never dispatched (no comparison against it in "
                            f"{mod.rel}) — events of this kind would be silently "
                            f"dropped",
                        )
                    )
                if kind not in constructed:
                    out.append(
                        mod.finding(
                            self.name, anchor, kind,
                            f"process kind {kind!r} is never constructed via "
                            f"FailureProcessSpec({kind!r}, ...) anywhere — no "
                            f"scenario family or test exercises it",
                        )
                    )
                if test_mods and kind not in test_strings:
                    out.append(
                        mod.finding(
                            self.name, anchor, kind,
                            f"process kind {kind!r} is not named in any test "
                            f"module — engine/fold parity for it is untested",
                        )
                    )
        return out

    @staticmethod
    def _constructed_process_kinds(project: Project) -> Set[str]:
        out: Set[str] = set()
        for mod in project.modules:
            for node in mod.nodes():
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name and name.split(".")[-1] == "FailureProcessSpec":
                    kind = str_arg(node, 0, keyword="kind")
                    if kind is not None:
                        out.add(kind)
        return out

    # ------------------------------------------------- trace-event kinds
    def _check_trace_kinds(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            assign = _assignment(mod, "_KIND_ORDER")
            if assign is None:
                continue
            kinds = _const_str_keys(assign.value)
            if not kinds:
                continue
            engine_side: Set[str] = set()
            fold_side: Set[str] = set()
            for m in project.by_role("src"):
                for kind, func in _emitted_kinds(m):
                    in_fold_func = func in FOLD_SIDE_FUNCS
                    in_shared = func in SHARED_FUNCS
                    if in_shared:
                        engine_side.add(kind)
                        fold_side.add(kind)
                    elif in_fold_func:
                        fold_side.add(kind)
                    elif func == "emit" and m is mod:
                        continue  # TraceRecorder.emit itself: kind is dynamic
                    else:
                        engine_side.add(kind)
            for kind, line in kinds:
                anchor = ast.Module(body=[], type_ignores=[])
                anchor.lineno = line
                if kind not in engine_side:
                    out.append(
                        mod.finding(
                            self.name, anchor, kind,
                            f"trace event kind {kind!r} has no engine-side "
                            f"emitter (recorder.emit / TraceEvent.make outside "
                            f"reconstruct_traces) — the live timeline can never "
                            f"contain it",
                        )
                    )
                if kind not in fold_side:
                    out.append(
                        mod.finding(
                            self.name, anchor, kind,
                            f"trace event kind {kind!r} is not produced by the "
                            f"fold-side reconstruction (reconstruct_traces / "
                            f"schedule_events) — engine≡fold event parity "
                            f"cannot hold for it",
                        )
                    )
                # emitted somewhere but not declared would crash at runtime
                # (TraceEvent.make validates) — no static check needed
        return out
