"""``no-wallclock-in-sim``: real time exists only in the orchestrator.

The simulator's determinism contract is that campaign time is a value
threaded through the engine (``t_s``, tapes, fake clocks), never read
from the host. The port's live orchestrator package is the single
deliberate exception (it supervises real processes, so it owns
``asyncio`` and the ``time.monotonic`` wall clock) and
``repro_torch/obs/profile.py`` may read monotonic time for profiling
hooks. Everywhere else in the port:

* ``import asyncio`` / ``from asyncio import ...`` is flagged — an event
  loop smuggles wall-clock scheduling into code that must replay
  identically from tapes;
* *calls* to ``time.monotonic`` / ``time.monotonic_ns`` (resolved
  through import aliases) are flagged. Storing the function as a default
  clock *reference* (``clock or time.monotonic``, as
  ``core/heartbeat.py`` does) stays legal: the caller decides whether
  real time flows in, which is exactly the injectable-clock idiom the
  simulator tests rely on.

Test and bench modules are exempt (they drive the real thing).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import ModuleSource, Project, call_name, dotted
from repro_torch.analysis.registry import register

#: rel-path fragments allowed to touch the wall clock / event loop
ALLOWED_FRAGMENTS = ("repro_torch/orchestrator/",)
ALLOWED_SUFFIXES = ("repro_torch/obs/profile.py",)

#: resolved call targets that read the wall clock
WALLCLOCK_CALLS = {"time.monotonic", "time.monotonic_ns"}


def _allowed(rel: str) -> bool:
    return any(f in rel for f in ALLOWED_FRAGMENTS) or rel.endswith(ALLOWED_SUFFIXES)


@register("no-wallclock-in-sim")
class NoWallclockInSimRule(Rule):
    description = (
        "only repro_torch.orchestrator may import asyncio or call time.monotonic "
        "(plus obs/profile.py for the latter); simulated code takes time as "
        "a value or an injected clock"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.by_role("src"):
            if _allowed(mod.rel):
                continue
            out.extend(self._check_module(mod))
        return out

    def _check_module(self, mod: ModuleSource) -> List[Finding]:
        aliases = mod.import_aliases()
        out: List[Finding] = []
        for node in mod.nodes():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "asyncio" or a.name.startswith("asyncio."):
                        out.append(
                            mod.finding(
                                self.name, node, "asyncio",
                                "asyncio import outside repro_torch.orchestrator: "
                                "event-loop scheduling breaks tape replay; "
                                "simulated code must not own a wall clock",
                            )
                        )
            elif isinstance(node, ast.ImportFrom):
                m = node.module or ""
                if m == "asyncio" or m.startswith("asyncio."):
                    out.append(
                        mod.finding(
                            self.name, node, "asyncio",
                            "asyncio import outside repro_torch.orchestrator: "
                            "event-loop scheduling breaks tape replay; "
                            "simulated code must not own a wall clock",
                        )
                    )
            elif isinstance(node, ast.Call):
                name = call_name(node, aliases)
                if name in WALLCLOCK_CALLS:
                    out.append(
                        mod.finding(
                            self.name, node, name,
                            f"`{dotted(node.func)}` called outside "
                            f"repro_torch.orchestrator / obs/profile.py: take the "
                            f"time as a parameter or accept an injected clock "
                            f"(clock=time.monotonic as a default *reference* "
                            f"is fine)",
                        )
                    )
        return out
