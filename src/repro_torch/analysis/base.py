"""The rule protocol: one invariant family, checked over a parsed
:class:`~repro_torch.analysis.project.Project`.

Rules are stateless classes registered through
:mod:`repro_torch.analysis.registry` (the same registration-ordered idiom as
strategies/detectors/workloads); ``check`` returns plain
:class:`~repro_torch.analysis.findings.Finding` rows and the runner applies
suppressions, sorting, and severity policy centrally.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Project


class Rule:
    """One invariant family.

    Subclasses set ``description`` (one line, shown by ``--list-rules``)
    and implement :meth:`check`. ``name`` is stamped by the registry's
    ``@register`` decorator."""

    name: str = ""
    description: str = ""

    def check(self, project: Project) -> List[Finding]:
        raise NotImplementedError
