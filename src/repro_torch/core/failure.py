"""Failure injection models (paper Fig. 16) + the event-stream interface.

The paper evaluates two single-node failure types:
  * periodic — fails a node a fixed offset after each checkpoint
    (paper: 15 min after C_n in Table 1; 14 min in Table 2);
  * random — uniform within each inter-checkpoint window (the paper reports
    a mean of 31 m 14 s over 5000 trials for a 1 h window, i.e. ~uniform).

Each failure event carries whether it is *predictable* (29 % in the paper)
and, if so, the prediction lead time (38 s). Node choice is uniform.

This module defines the **event-stream interface** consumed by the rest of
the system: anything with an ``events() -> List[FailureEvent]`` method is a
failure process (see ``EventStream``). ``FailureModel`` keeps the paper's
two single-node patterns bit-for-bit (same rng call sequence); richer
multi-failure campaigns — correlated rack outages, cascades onto the spare,
flaky repeat offenders, spare-pool exhaustion, checkpoint-time failures —
live in ``repro_torch.scenarios.spec`` and emit the same ``FailureEvent``
records with the extra metadata fields below.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

PREDICTABLE_FRACTION = 0.29  # paper §Discussion
PREDICTION_LEAD_S = 38.0  # paper: "time for predicting the fault is 38 seconds"
PREDICTION_PRECISION = 0.64  # paper: 64 / 100 predictions were real


@dataclass(frozen=True)
class FailureEvent:
    t: float  # seconds since job start
    node: int
    predictable: bool
    lead_s: float = PREDICTION_LEAD_S
    # --- scenario-engine metadata (defaults keep the paper's events) ------
    cause: str = "independent"  # independent|rack|cascade|flaky|burst|ckpt_window
    rack: Optional[int] = None  # rack id for correlated failures
    during_checkpoint: bool = False  # fired while a checkpoint was being cut
    cascade: Optional[dict] = None  # {"delay_s": d, "depth": k} -> the engine
    #   injects a follow-up failure on the migration TARGET (node unknown at
    #   stream-generation time, so cascades are resolved dynamically)

    def shifted(self, dt: float) -> "FailureEvent":
        return replace(self, t=self.t + dt)


@runtime_checkable
class EventStream(Protocol):
    """The failure-process interface: a time-ordered stream of events."""

    def events(self) -> List[FailureEvent]:  # pragma: no cover - protocol
        ...


@dataclass
class FailureModel:
    """The paper's two single-node patterns, as an :class:`EventStream`.

    Kept numerically identical to the seed implementation (same rng draw
    order) so Tables 1-2 reproduce exactly; registered in the scenario
    registry as ``table1_periodic`` / ``table2_random``.
    """

    kind: str  # "periodic" | "random" | "none"
    n_nodes: int
    horizon_s: float
    period_s: float = 3600.0  # failure-window length (checkpoint interval)
    offset_s: float = 900.0  # periodic: offset after window start
    per_window: int = 1  # failures per window (5 for the stress rows)
    seed: int = 0
    predictable_fraction: float = PREDICTABLE_FRACTION

    def events(self) -> List[FailureEvent]:
        rng = np.random.default_rng(self.seed)
        out: List[FailureEvent] = []
        if self.kind == "none" or self.horizon_s <= 0:
            return out
        n_windows = int(np.ceil(self.horizon_s / self.period_s))
        for w in range(n_windows):
            base = w * self.period_s
            for k in range(self.per_window):
                if self.kind == "periodic":
                    t = base + self.offset_s + k * (self.period_s / max(self.per_window, 1)) * 0.9
                else:
                    t = base + rng.uniform(0.0, self.period_s)
                if t >= self.horizon_s:
                    continue
                out.append(
                    FailureEvent(
                        t=float(t),
                        node=int(rng.integers(0, self.n_nodes)),
                        predictable=bool(rng.random() < self.predictable_fraction),
                    )
                )
        return sorted(out, key=lambda e: e.t)


def merge_streams(*streams: EventStream) -> List[FailureEvent]:
    """Merge several failure processes into one time-ordered event list."""
    out: List[FailureEvent] = []
    for s in streams:
        out.extend(s.events())
    return sorted(out, key=lambda e: e.t)


def mean_random_failure_time(period_s: float = 3600.0, trials: int = 5000, seed: int = 1):
    """Paper's 5000-trial mean of the random failure time within a window
    (reported 31 m 14 s for 1 h)."""
    rng = np.random.default_rng(seed)
    return float(np.mean(rng.uniform(0.0, period_s, size=trials)))
