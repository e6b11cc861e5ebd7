"""The finding data model: one rule violation, pinned to a source line.

Findings are plain, hashable, sortable records so rules can be tested by
value equality, the CLI can render them deterministically (path, then
line, then rule), and the JSON artifact CI uploads is stable across
runs.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

#: severity ladder; ``error`` findings fail the build, ``warning``s are
#: reported (and still fail the CLI unless ``--warnings-ok``)
SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``rule``      the registered rule name that fired
    ``path``      repo-relative posix path of the offending file
    ``line``      1-based source line the finding anchors to
    ``symbol``    the function/class/name the finding is about ("" ok)
    ``msg``       human-readable description with the expected fix
    ``severity``  "error" | "warning"
    """

    rule: str
    path: str
    line: int
    symbol: str
    msg: str
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r}; one of {SEVERITIES}"
            )

    def sort_key(self):
        return (self.path, self.line, self.rule, self.symbol, self.msg)

    def to_dict(self) -> Dict:
        return asdict(self)

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule} ({self.severity}){sym}: {self.msg}"
