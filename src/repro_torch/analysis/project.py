"""Project loader: parse a source tree into ASTs plus the shared lookup
helpers every rule uses (dotted-name resolution through import maps,
suppression comments, module role classification). The port's own copy
of ``repro/analysis/project.py``, with the port's roles: its tests and
their helper are "test", ``chip_smoke.py`` is "bench".

Nothing here imports or executes analyzed code — files are read as text
and parsed with stdlib :mod:`ast` only, so the linter can run on broken
or dependency-missing trees (and on the intentional-violation fixtures).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from fnmatch import fnmatch
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

#: ``# repro: ignore`` / ``# repro: ignore[rule-a, rule-b]`` on the
#: flagged line suppresses matching findings on that line
_IGNORE_RE = re.compile(r"#\s*repro:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")
#: ``# repro: ignore-file[rule]`` anywhere suppresses a rule file-wide
_IGNORE_FILE_RE = re.compile(r"#\s*repro:\s*ignore-file(?:\[([A-Za-z0-9_,\- ]+)\])?")


def _parse_rules(group: Optional[str]) -> Optional[Set[str]]:
    """``None`` means "all rules"; otherwise the named subset."""
    if group is None:
        return None
    return {r.strip() for r in group.split(",") if r.strip()}


@dataclass
class ModuleSource:
    """One parsed source file plus its lint-relevant metadata."""

    path: Path  # absolute
    rel: str  # root-relative posix path (what findings report)
    text: str
    tree: ast.Module
    #: "src" | "test" | "bench": rules scope themselves by role
    role: str
    #: line -> suppressed rule names (None = every rule)
    line_ignores: Dict[int, Optional[Set[str]]] = field(default_factory=dict)
    #: file-wide suppressions (None = every rule)
    file_ignores: Set[str] = field(default_factory=set)
    file_ignores_all: bool = False
    #: ``nodes()`` and ``import_aliases()``, computed once: every rule walks
    #: every module
    _nodes: Optional[List[ast.AST]] = field(default=None, repr=False)
    _aliases: Optional[Dict[str, str]] = field(default=None, repr=False)

    @classmethod
    def parse(cls, path: Path, rel: str) -> Optional["ModuleSource"]:
        text = path.read_text(encoding="utf-8", errors="replace")
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError:
            return None  # unparseable files are skipped, not crashed on
        mod = cls(path=path, rel=rel, text=text, tree=tree, role=_role(rel))
        for i, line in enumerate(text.splitlines(), start=1):
            m = _IGNORE_FILE_RE.search(line)
            if m:
                rules = _parse_rules(m.group(1))
                if rules is None:
                    mod.file_ignores_all = True
                else:
                    mod.file_ignores |= rules
                continue
            m = _IGNORE_RE.search(line)
            if m:
                mod.line_ignores[i] = _parse_rules(m.group(1))
        return mod

    # ------------------------------------------------------------ helpers
    def suppressed(self, rule: str, line: int) -> bool:
        if self.file_ignores_all or rule in self.file_ignores:
            return True
        if line in self.line_ignores:
            rules = self.line_ignores[line]
            return rules is None or rule in rules
        return False

    def nodes(self) -> List[ast.AST]:
        """Every node of the module, in ``ast.walk`` order."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def import_aliases(self) -> Dict[str, str]:
        """Local alias -> dotted origin, from top-level and nested imports
        (``import numpy as np`` -> ``{"np": "numpy"}``; ``from
        repro_torch.strategies import names as strategy_names`` ->
        ``{"strategy_names": "repro_torch.strategies.names"}``)."""
        if self._aliases is not None:
            return self._aliases
        out: Dict[str, str] = {}
        for node in self.nodes():
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        self._aliases = out
        return out

    def finding(self, rule: str, node: ast.AST, symbol: str, msg: str,
                severity: str = "error") -> Finding:
        return Finding(
            rule=rule,
            path=self.rel,
            line=getattr(node, "lineno", 1),
            symbol=symbol,
            msg=msg,
            severity=severity,
        )


#: test modules that are not named ``test_*``: the port's mesh helper
TEST_HELPERS = ("torch_mesh.py", "conftest.py")
#: the bench matrix until the port has a benchmark of its own
BENCH_FILES = ("chip_smoke.py",)


def _role(rel: str) -> str:
    name = Path(rel).name
    if name.startswith("test_") or name in TEST_HELPERS:
        return "test"
    if name.startswith("bench") or name in BENCH_FILES:
        return "bench"
    return "src"


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def expand(name: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    """Resolve the first segment of a dotted name through the module's
    import aliases (``np.random.rand`` -> ``numpy.random.rand``)."""
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin


def call_name(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """The fully-expanded dotted name of a call's target."""
    return expand(dotted(node.func), aliases)


def str_arg(node: ast.Call, index: int, keyword: Optional[str] = None) -> Optional[str]:
    """The string constant at positional ``index`` (or ``keyword=``)."""
    if len(node.args) > index:
        a = node.args[index]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    if keyword is not None:
        for kw in node.keywords:
            if kw.arg == keyword and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
    return None


def enclosing_functions(tree: ast.Module) -> Dict[ast.AST, Optional[str]]:
    """Map every node to the name of its innermost enclosing function."""
    out: Dict[ast.AST, Optional[str]] = {}

    def visit(node: ast.AST, fname: Optional[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fname = node.name
        out[node] = fname
        for child in ast.iter_child_nodes(node):
            visit(child, fname)

    visit(tree, None)
    return out


class Project:
    """The parsed source tree a rule checks: modules plus shared lookups."""

    def __init__(self, modules: Sequence[ModuleSource], root: Path):
        self.modules: List[ModuleSource] = list(modules)
        self.root = root

    @classmethod
    def load(
        cls,
        paths: Iterable[Path],
        root: Optional[Path] = None,
        exclude: Sequence[str] = (),
    ) -> "Project":
        """Parse every ``*.py`` under ``paths`` (files or directories).
        ``exclude`` holds fnmatch patterns against root-relative posix
        paths (e.g. ``*/fixtures/*``)."""
        paths = [Path(p).resolve() for p in paths]
        if root is None:
            root = _find_root(paths)
        files: List[Path] = []
        for p in paths:
            if p.is_file() and p.suffix == ".py":
                files.append(p)
            elif p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
        modules = []
        seen: Set[Path] = set()
        for f in files:
            if f in seen:
                continue
            seen.add(f)
            try:
                rel = f.relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            if any(fnmatch(rel, pat) or fnmatch("/" + rel, pat) for pat in exclude):
                continue
            mod = ModuleSource.parse(f, rel)
            if mod is not None:
                modules.append(mod)
        return cls(modules, root)

    # ------------------------------------------------------------ queries
    def by_role(self, role: str) -> List[ModuleSource]:
        return [m for m in self.modules if m.role == role]

    def find(self, suffix: str) -> Optional[ModuleSource]:
        """The module whose relative path ends with ``suffix``."""
        for m in self.modules:
            if m.rel.endswith(suffix):
                return m
        return None

    def string_literals(self, mod: ModuleSource) -> Set[str]:
        return {
            n.value
            for n in mod.nodes()
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
        }


def _find_root(paths: Sequence[Path]) -> Path:
    """Repo root: nearest ancestor of the first path holding a marker
    (``pytest.ini`` / ``.git`` / ``pyproject.toml``), else the common
    parent."""
    start = paths[0] if paths else Path.cwd()
    if start.is_file():
        start = start.parent
    for cand in (start, *start.parents):
        if any((cand / m).exists() for m in ("pytest.ini", ".git", "pyproject.toml")):
            return cand
    return start
