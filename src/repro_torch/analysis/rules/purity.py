"""``traced-purity``: no impure call is reachable from a function whose
result must be a pure function of its tensors.

The reference roots this rule at ``jax.jit`` / ``jax.vmap`` /
``pl.pallas_call``: a traced function runs once, and an impurity inside it
is baked into the compiled program. The port traces nothing, but the
same contract holds at other places, and an impure call there breaks the
port's guarantees just as silently:

* ``forward`` / ``backward`` of a ``torch.autograd.Function``: autograd
  runs the backward on a thread of its own, and a checkpointed block runs
  its forward again in the backward; a run under any fault-tolerance
  policy must end bit-identical to the failure-free run;
* the replay fold that ``scenarios/trajectory.py::_compiled_replayer``
  builds (with every closure it returns): that factory is cached
  (``lru_cache``), so a value it read once is reused by every later
  campaign, and the fold's trial-for-trial parity with the engine needs
  it to be a function of its tapes;
* ``scenarios/montecarlo.py::_mc_totals_draw``: its draws must come from
  the seed it is given;
* the workload cost-surface methods (``surfaces`` / ``at``), consumed
  inside the fold;
* any function handed to ``torch.utils.checkpoint.checkpoint``, which runs
  it again in the backward (directly, as ``self.<method>`` or through
  ``functools.partial``).

The impure calls are the reference's (wall clock, Python and numpy global
RNG, stdout, file I/O, environment, ``global`` statements) plus torch's
global RNG: ``torch.manual_seed`` / ``torch.seed``, the draws
``torch.{rand, randn, randint, randperm, bernoulli, multinomial, normal,
poisson}`` and the in-place draws (``x.uniform_()``, ``x.normal_()``, ...)
without ``generator=``. The port's rule is explicit generators.

The rule walks the *static call graph*: edges are calls to same-module
functions by name, and to methods through ``self.<name>`` (resolved to a
same-module function of that name). Any reachable impure call is flagged
with the root it leaks into.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import ModuleSource, Project, call_name, dotted, expand
from repro_torch.analysis.registry import register

#: dotted-prefix denylist: calls whose expanded name starts with one of
#: these are impure inside a root (the reference's list)
IMPURE_PREFIXES = (
    "time.",
    "random.",
    "numpy.random.",
    "secrets.",
    "uuid.",
    "os.urandom",
    "os.getenv",
    "os.environ",
    "datetime.datetime.now",
    "datetime.date.today",
)
#: exact impure builtins
IMPURE_NAMES = {"print", "input", "open", "breakpoint"}
#: constructing a seeded generator is pure: the sanctioned idiom
PURE_EXCEPTIONS = {
    "numpy.random.default_rng",
    "numpy.random.Generator",
    "numpy.random.SeedSequence",
}
#: torch's global RNG state, seeded or read
TORCH_GLOBAL_RNG = {
    "torch.manual_seed",
    "torch.seed",
    "torch.random.manual_seed",
    "torch.random.seed",
    "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
    "torch.cuda.seed",
}
#: torch draws that take the global RNG unless given ``generator=``
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal",
               "poisson"}
#: in-place tensor draws, the same
INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_", "geometric_",
                 "log_normal_", "cauchy_"}

#: calls whose function-valued arguments become roots: a checkpointed
#: function runs again in the backward, and must give the same tensors
ROOT_WRAPPERS = {"torch.utils.checkpoint.checkpoint"}
#: higher-order carriers: traversal descends into their function args
HIGHER_ORDER = ROOT_WRAPPERS | {"functools.partial", "partial"}
#: method names treated as roots in workload modules: cost surfaces are
#: consumed inside the fold, so they must stay pure themselves
SURFACE_ROOT_METHODS = {"surfaces", "at"}
#: rel-path suffix -> functions rooted there, each with every function
#: nested in it (the closures a factory returns)
ROOT_FUNCTIONS = {
    "repro_torch/scenarios/trajectory.py": ("_compiled_replayer",),
    "repro_torch/scenarios/montecarlo.py": ("_mc_totals_draw",),
}
#: the methods of an autograd Function that run under autograd
AUTOGRAD_METHODS = ("forward", "backward")


def _function_index(mod: ModuleSource) -> Dict[str, ast.AST]:
    """name -> the first FunctionDef of that name, at any nesting depth."""
    out: Dict[str, ast.AST] = {}
    for node in mod.nodes():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _callable_args(call: ast.Call) -> List[ast.AST]:
    """The plausible function-valued operands of a transform call."""
    return list(call.args) + [kw.value for kw in call.keywords]


def _self_method(expr: ast.AST) -> Optional[str]:
    """``name`` for ``self.name``, else None."""
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _is_autograd_function(cls: ast.ClassDef, aliases: Dict[str, str]) -> bool:
    for base in cls.bases:
        name = expand(dotted(base), aliases) or ""
        if name in ("torch.autograd.Function", "torch.autograd.function.Function"):
            return True
    return False


class _RootCollector:
    """Find every root function in one module."""

    def __init__(self, mod: ModuleSource, aliases: Dict[str, str]):
        self.mod = mod
        self.aliases = aliases
        self.index = _function_index(mod)
        self.roots: List[Tuple[str, ast.AST]] = []  # (root label, FunctionDef)
        self._seen: Set[int] = set()

    def collect(self) -> List[Tuple[str, ast.AST]]:
        for node in self.mod.nodes():
            if isinstance(node, ast.ClassDef) and _is_autograd_function(node, self.aliases):
                for stmt in node.body:
                    if isinstance(stmt, ast.FunctionDef) and stmt.name in AUTOGRAD_METHODS:
                        self._add(f"{node.name}.{stmt.name}", stmt)
            elif isinstance(node, ast.Call):
                if call_name(node, self.aliases) in ROOT_WRAPPERS:
                    for arg in _callable_args(node):
                        self._add_expr(arg)
        if "workloads" in self.mod.rel:
            for fname, fn in self.index.items():
                if fname in SURFACE_ROOT_METHODS:
                    self._add(fname, fn)
        for suffix, fnames in ROOT_FUNCTIONS.items():
            if ("/" + self.mod.rel).endswith("/" + suffix):
                for fname in fnames:
                    if fname in self.index:
                        self._add(fname, self.index[fname])
        return self.roots

    def _add(self, label: str, fn: ast.AST):
        if id(fn) not in self._seen:
            self._seen.add(id(fn))
            self.roots.append((label, fn))

    def _add_expr(self, expr: ast.AST):
        """A function-valued expression handed to a transform: a local
        function name, a lambda, or a nested wrapper call."""
        name = expr.id if isinstance(expr, ast.Name) else _self_method(expr)
        if name in self.index:
            self._add(name, self.index[name])
        elif isinstance(expr, ast.Lambda):
            self._add("<lambda>", expr)
        elif isinstance(expr, ast.Call) and call_name(expr, self.aliases) in HIGHER_ORDER:
            for a in _callable_args(expr):
                self._add_expr(a)


@register("traced-purity")
class TracedPurityRule(Rule):
    description = (
        "no wall-clock / global-RNG (torch's included) / I/O / global-mutation "
        "call reachable from an autograd Function, the replay fold, the "
        "Monte-Carlo draw, a cost surface or a checkpointed function"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.by_role("src"):
            aliases = mod.import_aliases()
            index = _function_index(mod)
            for label, fn in _RootCollector(mod, aliases).collect():
                out.extend(self._walk_root(mod, aliases, index, label, fn))
        return out

    # ------------------------------------------------------------------
    def _walk_root(
        self,
        mod: ModuleSource,
        aliases: Dict[str, str],
        index: Dict[str, ast.AST],
        root: str,
        fn: ast.AST,
        chain: Tuple[str, ...] = (),
        visited: Optional[Set[int]] = None,
    ) -> List[Finding]:
        if visited is None:
            visited = set()
        if id(fn) in visited:
            return []
        visited.add(id(fn))
        out: List[Finding] = []
        here = chain + (getattr(fn, "name", "<lambda>"),)
        via = " -> ".join(here)

        def descend(target: ast.AST):
            out.extend(self._walk_root(mod, aliases, index, root, target, here, visited))

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Global):
                    out.append(
                        mod.finding(
                            self.name, node, root,
                            f"root mutates module globals (`global "
                            f"{', '.join(node.names)}` via {via}): carry the "
                            f"state through the arguments instead",
                        )
                    )
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node, aliases)
                method = _self_method(node.func)
                if method in index and method not in INPLACE_DRAWS:
                    descend(index[method])
                    continue
                if name is None:
                    if _inplace_draw(node):  # e.g. ``x[0].normal_()``
                        out.append(self._finding(mod, node, root, via))
                    continue
                if _impure(name, node):
                    out.append(self._finding(mod, node, root, via))
                elif name in HIGHER_ORDER:
                    for arg in _callable_args(node):
                        if isinstance(arg, ast.Name) and arg.id in index:
                            descend(index[arg.id])
                        elif isinstance(arg, ast.Lambda):
                            descend(arg)
                elif "." not in name and name in index and name not in IMPURE_NAMES:
                    descend(index[name])
        return out

    def _finding(self, mod: ModuleSource, node: ast.Call, root: str, via: str) -> Finding:
        return mod.finding(
            self.name, node, root,
            f"impure call `{dotted(node.func) or ast.unparse(node.func)}` reachable from "
            f"a root (via {via}): the root must be a pure function of its tensors; draw "
            f"from an explicit torch.Generator / numpy Generator passed in",
        )


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _inplace_draw(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute) and call.func.attr in INPLACE_DRAWS
            and not _has_generator(call))


def _impure(name: str, call: ast.Call) -> bool:
    if name in PURE_EXCEPTIONS:
        return False
    if name in IMPURE_NAMES or name in TORCH_GLOBAL_RNG:
        return True
    head, _, leaf = name.rpartition(".")
    if head == "torch" and leaf in TORCH_DRAWS:
        return not _has_generator(call)
    if _inplace_draw(call):
        return True
    return any(name.startswith(p) for p in IMPURE_PREFIXES)
