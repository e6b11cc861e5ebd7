"""The unified fault-tolerance strategy API.

One protocol covers everything the repo previously encoded four different
ways (string tuples in ``core/sim.py``, an if/elif ladder in
``FTTrainer._migrate``, per-approach branches in the scenario-engine tick
loop, and ad-hoc unit method signatures):

* **closed-form accounting** — :meth:`FaultToleranceStrategy.costs`
  returns a :class:`StrategyCosts` record; ``core/sim.py`` turns it into
  the paper's Table 1-2 rows with the exact seed arithmetic;
* **live execution** — :meth:`attach` binds the strategy to a
  :class:`~repro_torch.core.runtime.ClusterRuntime`, then
  :meth:`on_prediction` / :meth:`on_failure` handle events and return a
  :class:`FailureOutcome` with the accounting deltas, while
  :meth:`probe` / :meth:`tick_costs` expose the background monitoring
  side of the mechanism.

Placement (which host receives displaced work) is a pluggable
:class:`~repro_torch.strategies.placement.PlacementPolicy` injected at
construction time, never hard-wired.

Register implementations with :func:`repro_torch.strategies.registry.register`;
anything in the registry automatically appears in the table benchmarks,
the scenario engine, campaigns and Monte-Carlo reports.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class StrategyCosts:
    """Per-failure closed-form cost components of one strategy at one
    checkpoint periodicity — the numbers previously scattered through
    ``MicroCosts`` consumers.

    ``total = J + probe_s_per_hour·hours
            + Σ_failures (lost + reinstate_s + predict_s + overhead_s)``

    where ``lost`` is the elapsed re-execution time when
    ``lost_progress`` is True (reactive policies) and zero otherwise
    (proactive migration preserves progress)."""

    predict_s: float  # prediction lead paid per handled failure
    reinstate_s: float  # state re-instatement per failure
    overhead_s: float  # staging / log-mining / restore overhead per failure
    probe_s_per_hour: float = 0.0  # continuous background probing
    lost_progress: bool = True  # does a failure lose elapsed work?

    def finite(self) -> bool:
        return all(
            np.isfinite(v)
            for v in (self.predict_s, self.reinstate_s, self.overhead_s, self.probe_s_per_hour)
        )


@dataclass(frozen=True)
class StrategyCostTable:
    """Vectorised (structure-of-arrays-ready) form of :class:`StrategyCosts`
    for the batched trajectory replay fold
    (:mod:`repro_torch.scenarios.trajectory`).

    Where :class:`StrategyCosts` is one closed-form per-failure record,
    this table carries every coefficient the replay kernel may need to
    bill an *arbitrary* event in one batched fold — including both
    mechanism pairs for strategies that pick agent vs core migration per
    event — so the per-event cost is a pure arithmetic function of
    ``(t, predictable, during_checkpoint, Z)`` with no Python dispatch.

    ``mode`` selects the loss clock:

    ``"window"``
        reactive: a failure loses the elapsed time since the window
        start (the checkpoint policies; also the default reduction of a
        custom reactive strategy's ``costs()``);
    ``"proactive"``
        predicted failures lose nothing (lead-window migration); blind
        failures replay from the window-start progress mark; reinstate/
        overhead are priced per mechanism;
    ``"cold"``
        a failure loses everything since the sub-job's last (re)start
        (per-host attempt clock).
    """

    mode: str  # "window" | "proactive" | "cold"
    proactive: bool = False
    probe_s_per_hour: float = 0.0
    predict_s: float = 0.0  # lead paid per *predicted* failure
    # window/cold-mode scalars
    reinstate_s: float = 0.0
    overhead_s: float = 0.0
    # a failure during checkpoint creation invalidates the in-flight
    # checkpoint: +1 window of lost progress, +50 % overhead (the live
    # CheckpointStrategy.on_failure semantics)
    ckpt_invalidation: bool = False
    # proactive per-mechanism pairs (overhead already growth-scaled)
    agent_reinstate_s: float = 0.0
    agent_overhead_s: float = 0.0
    core_reinstate_s: float = 0.0
    core_overhead_s: float = 0.0
    mechanism: str = "core"  # "agent" | "core" | "rules" (Z-negotiated per event)

    def finite(self) -> bool:
        return all(
            np.isfinite(v)
            for v in (
                self.predict_s,
                self.reinstate_s,
                self.overhead_s,
                self.probe_s_per_hour,
                self.agent_reinstate_s,
                self.agent_overhead_s,
                self.core_reinstate_s,
                self.core_overhead_s,
            )
        )


@dataclass(frozen=True)
class CostContext:
    """Inputs a strategy needs to price itself: the measured/modelled
    micro-costs plus the experiment geometry (the hybrid's Rules 1-3
    negotiation depends on Z and S_d)."""

    micro: object  # repro_torch.core.sim.MicroCosts (duck-typed; no sim import)
    period_h: float
    z: int = 4
    s_d_bytes: int = (2 ** 19) * 1024


@dataclass
class StrategyRow:
    """One Table 1/2 row (moved from ``core/sim.py``, which re-exports)."""

    strategy: str
    periodicity_h: float
    predict_s: float
    reinstate_periodic_s: float
    reinstate_random_s: float
    overhead_periodic_s: float
    overhead_random_s: float
    exec_nofail_s: float
    exec_1periodic_s: float
    exec_1random_s: float
    exec_5random_s: float


@dataclass
class FailureOutcome:
    """What handling one failure event cost, returned by
    :meth:`FaultToleranceStrategy.on_failure` / :meth:`on_prediction`."""

    new_host: int
    lost_s: float
    reinstate_s: float
    overhead_s: float
    outcome: str  # "migrated" | "restored" | "restarted"
    migrated: bool = False
    mechanism: Optional[str] = None  # which mechanism actually moved it
    report: Dict = field(default_factory=dict)  # raw unit migration report


class FaultToleranceStrategy(ABC):
    """Base class for every fault-tolerance approach.

    Class attributes describe the strategy's shape:

    ``proactive``
        predicts failures and migrates ahead of them (no progress loss);
    ``tabulated``
        priced per checkpoint-periodicity in the paper tables (cold
        restart instead contributes one table row via
        :meth:`table_rows`);
    ``wants_checkpoints``
        whether the live trainer should keep a checkpoint cadence as the
        reactive backstop.
    """

    name: str = "?"
    proactive: bool = False
    tabulated: bool = True
    wants_checkpoints: bool = True

    def __init__(self, placement=None):
        from repro_torch.strategies.placement import get_placement

        if isinstance(placement, str) or placement is None:
            placement = get_placement(placement or "nearest-spare")
        self.placement = placement
        self.rt = None
        self.units: Dict[int, object] = {}
        self.micro = None
        self.period_s: float = 3600.0

    # ---------------------------------------------------- closed form ---
    @abstractmethod
    def costs(self, ctx: CostContext) -> StrategyCosts:
        """Per-failure accounting at ``ctx.period_h`` — feeds Tables 1-2,
        the scenario engine's billing and the Monte-Carlo reduction."""

    def table_rows(self, job_hours: float) -> Optional[List[StrategyRow]]:
        """Rows outside the per-periodicity grid (``tabulated=False``
        strategies such as cold restart). Default: none."""
        return None

    def cost_table(self, ctx: CostContext) -> StrategyCostTable:
        """Batched per-event cost coefficients for the trajectory replay
        fold (:mod:`repro_torch.scenarios.trajectory`).

        The default reduces the scalar :meth:`costs` record: reactive
        strategies bill window-clock losses, proactive ones bill the same
        reinstate/overhead pair for either mechanism. Builtin adapters
        override to expose their richer live semantics (checkpoint
        invalidation, per-mechanism pricing, cold-restart clocks) so the
        kernel reproduces the engine's billing exactly."""
        c = self.costs(ctx)
        if self.proactive:
            return StrategyCostTable(
                mode="proactive",
                proactive=True,
                probe_s_per_hour=self.tick_costs(),
                predict_s=c.predict_s,
                agent_reinstate_s=c.reinstate_s,
                agent_overhead_s=c.overhead_s,
                core_reinstate_s=c.reinstate_s,
                core_overhead_s=c.overhead_s,
            )
        return StrategyCostTable(
            mode="window",
            probe_s_per_hour=self.tick_costs(),
            reinstate_s=c.reinstate_s,
            overhead_s=c.overhead_s,
        )

    # ------------------------------------------------------- lifecycle ---
    def attach(self, rt, hosts: Dict[int, object], micro=None, period_s: float = 3600.0):
        """Bind to a runtime and place the sub-job payloads on ``hosts``."""
        self.rt = rt
        self.micro = micro
        self.period_s = float(period_s)
        for h, payload in hosts.items():
            rt.occupy(h, payload, f"{self.name}:{h}")
            self._attach_host(h, payload)

    def _attach_host(self, host: int, payload: object):
        """Hook: proactive strategies create their per-host unit here."""

    def probe(self) -> Dict[int, bool]:
        """Probe the supervised hosts; {host: failure_predicted}."""
        return {}

    def tick_costs(self) -> float:
        """Background monitoring cost in seconds per hour of runtime."""
        return 0.0

    def has_work(self, host: int) -> bool:
        return host in self.units or self.rt.hosts[host].shard is not None

    def pick_target(self, failing: int, require_free: bool = False) -> Optional[int]:
        return self.placement.pick(self.rt, failing, require_free=require_free)

    def sync(self, host: int, payload: object):
        """Keep unit payload references fresh (live training loop)."""

    def rehome(self, old_host: int, new_host: int, payload: object):
        """Re-point the strategy after an external restore moved the work."""

    # ------------------------------------------------------- handling ---
    @abstractmethod
    def on_failure(self, event, target: int) -> FailureOutcome:
        """Handle a failure that was NOT predicted (reactive path)."""

    def on_prediction(self, event, target: int) -> FailureOutcome:
        """Handle a predicted failure (lead window). Reactive strategies
        cannot exploit the prediction: same as :meth:`on_failure`."""
        return self.on_failure(event, target)

    # -------------------------------------------------------- helpers ---
    def _window_start(self, t: float) -> float:
        return float(np.floor(t / self.period_s) * self.period_s)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r} placement={self.placement!r}>"
