"""Fault injectors: replay a compiled campaign's failure stream on real
processes.

The port of ``repro.orchestrator.injector``: the same injectors, names
and schedules, over the port's compiled tape. The simulator bills a
:class:`~repro_torch.scenarios.spec.ScenarioSpec`'s
failure stream; a live run must *suffer* the same stream, or live and
predicted makespans are not comparable. An :class:`Injector` turns the
spec's compiled trajectory tape (the exact per-seed event schedule the
engine and the replay fold consume) into a list of timed
:class:`Injection` actions the daemon fires on its worker processes:

=========  ===========================================================
``none``   no injections (baseline / external-chaos runs)
``kill``   SIGKILL the victim at the event instant (unannounced death —
           the paper's unpredictable failure)
``stall``  SIGSTOP the victim: heartbeats freeze, the stall detector
           must notice and reap it (the hung-node failure mode)
``slow``   command the victim to pace its steps ``factor`` x slower (a
           degrading-but-alive straggler; no death)
=========  ===========================================================

Cascade events carry ``slot``/``parent`` linkage: the daemon resolves
the actual victim at fire time (a cascade child chases the host its
parent's sub-job migrated to), exactly like the engine's tick loop.

Register implementations with
:func:`repro_torch.orchestrator.registry.register`; anything registered is
schedulable from the CLI.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.orchestrator.registry import register

#: actions a handle must implement (signal-level or command-level)
ACTIONS = ("kill", "stall", "slow", "die")


@dataclass(frozen=True)
class Injection:
    """One scheduled fault: tape slot ``slot`` fires ``action`` at sim
    time ``t_s`` (victim resolved by the daemon at fire time)."""

    slot: int
    t_s: float
    action: str
    factor: float = 1.0  # pacing multiplier, "slow" only

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown injection action {self.action!r}; one of {ACTIONS}")


class Injector(ABC):
    """Base class for every fault injector."""

    name: str = "?"

    @abstractmethod
    def schedule(self, tape) -> List[Injection]:
        """Timed injections for one compiled trajectory tape
        (:class:`repro_torch.scenarios.trajectory.TrajectoryTape`)."""

    def _real_slots(self, tape) -> List[int]:
        """Tape slots carrying real (finite-time) events, schedule order."""
        return [j for j in range(tape.n_slots) if np.isfinite(tape.times[j])]

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


@register("none", aliases=("off",))
class NoInjector(Injector):
    """No injections: supervise only (external or organic failures)."""

    def schedule(self, tape) -> List[Injection]:
        return []


@register("kill", aliases=("sigkill",))
class KillInjector(Injector):
    """SIGKILL every scheduled victim at its event instant."""

    def schedule(self, tape) -> List[Injection]:
        return [Injection(j, float(tape.times[j]), "kill") for j in self._real_slots(tape)]


@register("stall", aliases=("sigstop",))
class StallInjector(Injector):
    """SIGSTOP every scheduled victim: the daemon's heartbeat stall
    detector must notice the frozen worker and reap it."""

    def schedule(self, tape) -> List[Injection]:
        return [Injection(j, float(tape.times[j]), "stall") for j in self._real_slots(tape)]


@register("slow", aliases=("degrade",))
class SlowInjector(Injector):
    """Pace every scheduled victim ``factor`` x slower instead of killing
    it — the straggler failure mode the EWMA detector flags."""

    def __init__(self, factor: float = 2.0):
        self.factor = float(factor)

    def schedule(self, tape) -> List[Injection]:
        return [
            Injection(j, float(tape.times[j]), "slow", factor=self.factor)
            for j in self._real_slots(tape)
        ]
