"""Run rules over a project and apply suppression/sort policy centrally."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import all_rules, get


def run_analysis(
    project: Project, rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Execute the requested rules (default: every registered rule, in
    registration order) and return the surviving findings, suppression-
    filtered and deterministically sorted."""
    selected = all_rules() if rules is None else [get(r) for r in rules]
    by_rel: Dict[str, object] = {m.rel: m for m in project.modules}
    out: List[Finding] = []
    for rule in selected:
        for f in rule.check(project):
            mod = by_rel.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            out.append(f)
    return sorted(set(out), key=Finding.sort_key)
