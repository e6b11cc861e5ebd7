"""``dtype-x64``: explicit dtypes in the float64 fold's modules and the
kernel modules; no 32/16-bit float literals or casts in the fold's.

The replay fold's parity contract is *float64 arithmetic, identical to
the engine's*. The reference gets it by building its kernel under
``enable_x64``; the port writes every dtype out. A dtype-less
``torch.zeros(H)`` there is float32 (torch's default), and a dtype-less
``torch.as_tensor(x)`` takes whatever ``x`` happens to be: either shears
the accumulators off the engine's float64, and every differential test
starts chasing phantom drift. Kernel modules get the same explicit-dtype
check (a kernel's buffers are dtype contracts with the compiled code);
the narrow-float check applies only to the fold's modules, where
``torch.float32`` or ``np.float32`` is either a bug or a deliberate
engine-fidelity constant (mark those with ``# repro: ignore[dtype-x64]``).

Scope: a module is an **x64 module** if its path matches ``X64_PATTERNS``
(the modules that build float64 fold state: the replay fold and the
Monte-Carlo draw), and a **kernel module** if its path matches
``KERNEL_PATTERNS``. The constructors checked are torch's and numpy's; a
dtype counts given by keyword or at the position the constructor takes
it.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import ModuleSource, Project, dotted, expand
from repro_torch.analysis.registry import register

#: (module, constructor) -> the positional index where dtype may sit
#: (None: keyword only). numpy's are the reference's list, which it
#: checks on ``jax.numpy``
CONSTRUCTORS = {
    **{("torch", leaf): None for leaf in
       ("zeros", "ones", "empty", "full", "arange", "linspace", "tensor")},
    ("torch", "as_tensor"): 1,
    **{("numpy", leaf): 1 for leaf in ("zeros", "ones", "empty", "asarray", "array")},
    ("numpy", "full"): 2,
    ("numpy", "arange"): 3,
    ("numpy", "linspace"): 5,
}
#: 32/16-bit float dtypes that must not appear in x64 modules
NARROW_TORCH = {"float32", "float", "float16", "half", "bfloat16"}
NARROW_NUMPY = {"float32", "float16"}
#: tensor methods that cast to a narrow float
NARROW_CASTS = {"float", "half", "bfloat16"}

X64_PATTERNS = ("repro_torch/scenarios/trajectory.py", "repro_torch/scenarios/montecarlo.py")
KERNEL_PATTERNS = ("/kernels/",)
ARTICLE = {"x64": "an x64", "kernel": "a kernel"}


def _mode(mod: ModuleSource) -> Optional[str]:
    """"x64" | "kernel" | None: which check set applies."""
    rel = "/" + mod.rel
    if any(rel.endswith("/" + p) for p in X64_PATTERNS):
        return "x64"
    if any(p in rel for p in KERNEL_PATTERNS):
        return "kernel"
    return None


def _has_dtype(call: ast.Call, positional_index: Optional[int]) -> bool:
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    return positional_index is not None and len(call.args) > positional_index


def _narrow_literal(name: str) -> bool:
    head, _, leaf = name.rpartition(".")
    return (head == "torch" and leaf in NARROW_TORCH) or (head == "numpy" and leaf in NARROW_NUMPY)


@register("dtype-x64")
class DtypeX64Rule(Rule):
    description = (
        "the float64 fold's modules and the kernel modules construct tensors "
        "and arrays with explicit dtypes; the fold's carry no f32/f16/bf16 "
        "literals or casts"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.by_role("src"):
            aliases = mod.import_aliases()
            mode = _mode(mod)
            if mode is None:
                continue
            for node in mod.nodes():
                if isinstance(node, ast.Call):
                    name = expand(dotted(node.func), aliases)
                    head, _, leaf = (name or "").rpartition(".")
                    if (head, leaf) in CONSTRUCTORS and not _has_dtype(
                            node, CONSTRUCTORS[(head, leaf)]):
                        out.append(
                            mod.finding(
                                self.name, node, leaf,
                                f"dtype-less `{dotted(node.func)}(...)` in "
                                f"{ARTICLE[mode]} module: pass an explicit dtype, so that "
                                f"the tensor's precision does not depend on "
                                f"torch's default or on its input",
                            )
                        )
                    elif (mode == "x64" and isinstance(node.func, ast.Attribute)
                          and node.func.attr in NARROW_CASTS and not node.args
                          and not node.keywords):
                        out.append(
                            mod.finding(
                                self.name, node, node.func.attr,
                                f"narrow cast `.{node.func.attr}()` in an x64 "
                                f"module: the fold's parity contract is float64",
                            )
                        )
                elif mode == "x64" and isinstance(node, ast.Attribute):
                    name = expand(dotted(node), aliases)
                    if name and _narrow_literal(name):
                        out.append(
                            mod.finding(
                                self.name, node, name.split(".")[-1],
                                f"narrow float literal `{dotted(node)}` in an "
                                f"x64 module: the fold's parity contract is "
                                f"float64; if this constant deliberately mirrors "
                                f"engine state, mark the line "
                                f"`# repro: ignore[dtype-x64]`",
                            )
                        )
        return out
