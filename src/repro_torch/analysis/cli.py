"""``python -m repro_torch.analysis``: run the port's invariant linter
from the shell.

Text output by default (one line per finding, grep-friendly), ``--json``
for the machine-readable record. Exit status is the contract: 0 when the
tree is clean, 1 when any finding survives suppression, 2 when a path
does not exist.

When a scanned directory is the port's package (``src/repro_torch``), its
siblings are pulled in automatically, because the parity and registry
rules check coverage *across* them: the port's tests
(``tests/test_torch_*.py`` and their helper ``tests/torch_mesh.py``) and
``chip_smoke.py``, which stands in for the bench matrix. The reference
package (``src/repro``) and its tests are never pulled in. Pass
``--no-siblings`` to scan exactly the given paths. Fixture trees are
excluded by default (``*/fixtures/*``) so the intentional-violation
corpus never pollutes a real run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import all_rules, names
from repro_torch.analysis.runner import run_analysis

#: bumped when the JSON layout changes; the tests pin it
JSON_SCHEMA_VERSION = 1
DEFAULT_EXCLUDES = ("*/fixtures/*",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant linter of the PyTorch port: traced-purity, parity "
        "coverage, registry completeness, units, dtype and wall-clock discipline.",
    )
    p.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files/directories to analyze (default: src/repro_torch)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated subset of rules to run (default: all)",
    )
    p.add_argument("--json", action="store_true", help="emit the JSON record")
    p.add_argument(
        "--list-rules", action="store_true", help="list registered rules and exit"
    )
    p.add_argument(
        "--no-siblings", action="store_true",
        help="do not auto-include the port's tests and chip_smoke.py next to "
        "src/repro_torch",
    )
    p.add_argument(
        "--exclude", action="append", default=None, metavar="GLOB",
        help=f"fnmatch pattern to skip (repeatable; default: {DEFAULT_EXCLUDES})",
    )
    return p


def siblings(root: Path) -> List[Path]:
    """The port's tests and ``chip_smoke.py`` in the checkout at ``root``."""
    tests = root / "tests"
    out = sorted(tests.glob("test_torch_*.py")) if tests.is_dir() else []
    out += [f for f in (tests / "torch_mesh.py", root / "chip_smoke.py") if f.is_file()]
    return out


def resolve_paths(raw: Sequence[str], no_siblings: bool) -> List[Path]:
    paths = [Path(p) for p in raw]
    if no_siblings:
        return paths
    out = list(paths)
    for p in paths:
        pkg = p.resolve()
        if p.is_dir() and pkg.name == "repro_torch" and pkg.parent.name == "src":
            seen = {q.resolve() for q in out}
            out.extend(f for f in siblings(pkg.parent.parent) if f.resolve() not in seen)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name:24s} {rule.description}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    paths = resolve_paths(args.paths, args.no_siblings)
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path(s): {', '.join(map(str, missing))}", file=sys.stderr)
        return 2
    exclude = tuple(args.exclude) if args.exclude else DEFAULT_EXCLUDES
    project = Project.load(paths, exclude=exclude)
    findings = run_analysis(project, rules)

    if args.json:
        print(json.dumps(to_json(project, findings, rules), indent=2))
    else:
        for f in findings:
            print(f.render())
        n_files = len(project.modules)
        if findings:
            print(f"\n{len(findings)} finding(s) in {n_files} file(s) analyzed")
        else:
            print(f"clean: 0 findings in {n_files} file(s) analyzed")
    return 1 if findings else 0


def to_json(project: Project, findings: List[Finding], rules) -> dict:
    return {
        "schema_version": JSON_SCHEMA_VERSION,
        "rules": rules or names(),
        "n_files": len(project.modules),
        "n_findings": len(findings),
        "clean": not findings,
        "findings": [f.to_dict() for f in findings],
    }
