"""The paper's strategies as registry adapters.

Six table strategies — three reactive checkpoint policies
(``central_single``, ``central_multi``, ``decentral``), three proactive
mechanisms (``agent``, ``core``, ``hybrid``) — plus the ``cold_restart``
baseline.  Each adapter prices itself through the closed-form cost model
(byte-identical to the seed ``strategy_rows`` arithmetic) AND drives the
real migration machinery when attached to a runtime, so the same object
serves Tables 1-2, the live trainer and the scenario engine.

Registration order here is the table row order — append new strategies
after these to keep the seed CSVs byte-identical prefixes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.agent import Agent
from repro_torch.core.failure import mean_random_failure_time
from repro_torch.core.hybrid import HybridUnit
from repro_torch.core.rules import decide
from repro_torch.core.virtual_core import VirtualCore
from repro_torch.strategies.base import (
    CostContext,
    FailureOutcome,
    FaultToleranceStrategy,
    StrategyCostTable,
    StrategyCosts,
    StrategyRow,
)
from repro_torch.strategies.costmodel import (
    COLD_REINSTATE_S,
    PROBE_S_PER_HOUR,
    checkpoint_costs,
    proactive_mech_costs,
)
from repro_torch.strategies.registry import register


# ---------------------------------------------------------------- cold ---
@register("cold_restart")
class ColdRestart(FaultToleranceStrategy):
    """No fault tolerance: a failure loses everything the failed host's
    sub-job computed since its last (re)start, tracked per host.

    The closed-form ``table_rows`` uses the paper tables' first-crossing
    progress-mark semantics instead (each failure billed at its elapsed
    progress mark — see the ``core/sim.py`` module docstring for why the
    paper's cold-restart schedule cannot be reproduced exactly); the two
    models agree only for the single-restart case, so closed-form and
    engine cold totals are deliberately different accountings."""

    tabulated = False
    wants_checkpoints = False

    def costs(self, ctx: CostContext) -> StrategyCosts:
        return StrategyCosts(
            predict_s=0.0,
            reinstate_s=COLD_REINSTATE_S,
            overhead_s=0.0,
            lost_progress=True,
        )

    def cost_table(self, ctx: CostContext) -> StrategyCostTable:
        # cold mode: the replay kernel advances a per-host attempt clock
        # instead of the window clock, matching on_failure below
        return StrategyCostTable(mode="cold", reinstate_s=COLD_REINSTATE_S)

    def table_rows(self, job_hours: float) -> List[StrategyRow]:
        J = job_hours * 3600.0
        prog_marks = [h * 3600 + 14 * 60 for h in range(int(job_hours))]
        rand_mean = mean_random_failure_time(3600.0)
        cold_periodic = J + sum(e + COLD_REINSTATE_S for e in prog_marks)
        # random: mean elapsed since start for failure i ~ i*3600 + rand_mean
        cold_random = J + sum(
            h * 3600 + rand_mean + COLD_REINSTATE_S for h in range(int(job_hours))
        )
        cold_random5 = J + 5 * sum(
            h * 3600 + rand_mean + COLD_REINSTATE_S for h in range(int(job_hours))
        )
        return [
            StrategyRow(
                self.name, 0.0, 0.0, COLD_REINSTATE_S, COLD_REINSTATE_S, 0.0, 0.0,
                J, cold_periodic, cold_random, cold_random5,
            )
        ]

    def attach(self, rt, hosts, micro=None, period_s: float = 3600.0):
        super().attach(rt, hosts, micro=micro, period_s=period_s)
        # per-host restart clock: each sub-job loses ITS OWN elapsed work
        self._attempt_start = {h: 0.0 for h in hosts}

    def on_failure(self, event, target: int) -> FailureOutcome:
        rt = self.rt
        host = event.node
        shard = rt.hosts[host].shard
        rt.release(host)
        rt.occupy(target, shard, f"{self.name}:{host}")
        rt.graph.remap(host, target)
        lost = float(event.t) - self._attempt_start.pop(host, 0.0)
        self._attempt_start[target] = float(event.t)
        return FailureOutcome(
            new_host=int(target),
            lost_s=lost,
            reinstate_s=COLD_REINSTATE_S,
            overhead_s=0.0,
            outcome="restarted",
        )


# ---------------------------------------------------------- checkpoint ---
class CheckpointStrategy(FaultToleranceStrategy):
    """Reactive checkpoint/restore. A failure loses the elapsed time since
    the last completed checkpoint; a failure *during* checkpoint creation
    additionally invalidates the in-flight checkpoint (restore from the
    one a full window back, plus the wasted partial write)."""

    kind: str = "?"

    def costs(self, ctx: CostContext) -> StrategyCosts:
        rst, ovh = checkpoint_costs(ctx.micro, self.kind, ctx.period_h)
        return StrategyCosts(
            predict_s=0.0,
            reinstate_s=rst,
            overhead_s=ovh,
            lost_progress=True,
        )

    def cost_table(self, ctx: CostContext) -> StrategyCostTable:
        rst, ovh = checkpoint_costs(ctx.micro, self.kind, ctx.period_h)
        return StrategyCostTable(
            mode="window",
            reinstate_s=rst,
            overhead_s=ovh,
            ckpt_invalidation=True,
        )

    def on_failure(self, event, target: int) -> FailureOutcome:
        rt = self.rt
        host = event.node
        t = float(event.t)
        # checkpoint restore onto the target (no live migration)
        shard = rt.hosts[host].shard
        rt.release(host)
        rt.occupy(target, shard, f"{self.name}:{host}")
        rt.graph.remap(host, target)
        c = self.costs(CostContext(micro=self.micro, period_h=self.period_s / 3600.0))
        extra_ovh = 0.0
        if event.during_checkpoint:
            # in-flight checkpoint invalidated: restore from the one a
            # full window back, plus the wasted partial write
            lost = (t - self._window_start(t)) + self.period_s
            extra_ovh = 0.5 * c.overhead_s
        else:
            lost = t - self._window_start(t)
        return FailureOutcome(
            new_host=int(target),
            lost_s=lost,
            reinstate_s=c.reinstate_s,
            overhead_s=c.overhead_s + extra_ovh,
            outcome="restored",
        )


@register("central_single", aliases=("checkpoint",))
class CentralSingleCheckpoint(CheckpointStrategy):
    kind = "central_single"


@register("central_multi")
class CentralMultiCheckpoint(CheckpointStrategy):
    kind = "central_multi"


@register("decentral")
class DecentralCheckpoint(CheckpointStrategy):
    kind = "decentral"


# ------------------------------------------------------------ proactive ---
class ProactiveStrategy(FaultToleranceStrategy):
    """Prediction + live migration. Predictable failures are handled in
    the lead window (no progress lost); blind failures still migrate but
    replay from the window-start progress mark, because the proactive
    approaches keep no byte-level checkpoints."""

    proactive = True
    probe_mechanism: str = "agent"  # whose background probing is billed
    replay_mechanism: str = "core"  # batched billing: "agent" | "core" | "rules"

    # unit plumbing ------------------------------------------------------
    def _make_unit(self, host: int, payload: object):
        raise NotImplementedError

    def _migrate_unit(self, unit, rt, target: Optional[int]) -> Dict:
        raise NotImplementedError

    def _probe_unit(self, unit, rt) -> bool:
        return unit.probe(rt)

    def _attach_host(self, host: int, payload: object):
        self.units[host] = self._make_unit(host, payload)

    # lifecycle ----------------------------------------------------------
    def probe(self) -> Dict[int, bool]:
        return {h: self._probe_unit(u, self.rt) for h, u in self.units.items()}

    def tick_costs(self) -> float:
        return PROBE_S_PER_HOUR[self.probe_mechanism]

    def migrate(self, host: int, target: Optional[int] = None) -> Dict:
        """Move the unit on ``host`` (placement picks the target when not
        given); returns the unit's hash-verified migration report."""
        unit = self.units.pop(host)
        if target is None:
            target = self.pick_target(host)
        rep = self._migrate_unit(unit, self.rt, target)
        assert rep["hash_ok"]
        self.units[unit.host] = unit
        return rep

    def sync(self, host: int, payload: object):
        unit = self.units.get(host)
        if unit is not None:
            self._set_payload(unit, payload)

    def rehome(self, old_host: int, new_host: int, payload: object):
        unit = self.units.pop(old_host, None)
        if unit is None:
            # stale old_host is only re-pointable when there is exactly one
            # unit (the trainer's single-worker deployment); with several,
            # stealing an arbitrary healthy host's unit would corrupt it
            if len(self.units) != 1:
                return
            unit = self.units.pop(next(iter(self.units)))
        self._set_host(unit, new_host)
        self._set_payload(unit, payload)
        self.units[new_host] = unit

    def _set_payload(self, unit, payload):
        pass

    def _set_host(self, unit, host: int):
        unit.host = host

    # closed form --------------------------------------------------------
    def _cost_mechanism(self, ctx: CostContext) -> str:
        raise NotImplementedError

    def _mech_costs(self, mechanism: str, period_h: float, micro=None):
        m = self.micro if micro is None else micro
        return proactive_mech_costs(m, mechanism, period_h)

    def costs(self, ctx: CostContext) -> StrategyCosts:
        mech = self._cost_mechanism(ctx)
        rst, ovh = proactive_mech_costs(ctx.micro, mech, ctx.period_h)
        return StrategyCosts(
            predict_s=ctx.micro.predict_s,
            reinstate_s=rst,
            overhead_s=ovh,
            probe_s_per_hour=PROBE_S_PER_HOUR[mech],
            lost_progress=False,
        )

    def cost_table(self, ctx: CostContext) -> StrategyCostTable:
        # both mechanism pairs: the kernel bills whichever one each event's
        # negotiation resolves to (static for agent/core; Rules 1-3 Z-test
        # per event when replay_mechanism == "rules")
        a_rst, a_ovh = proactive_mech_costs(ctx.micro, "agent", ctx.period_h)
        c_rst, c_ovh = proactive_mech_costs(ctx.micro, "core", ctx.period_h)
        return StrategyCostTable(
            mode="proactive",
            proactive=True,
            probe_s_per_hour=self.tick_costs(),
            predict_s=ctx.micro.predict_s,
            agent_reinstate_s=a_rst,
            agent_overhead_s=a_ovh,
            core_reinstate_s=c_rst,
            core_overhead_s=c_ovh,
            mechanism=self.replay_mechanism,
        )

    # handling -----------------------------------------------------------
    def _handle(self, event, target: int, predicted: bool) -> FailureOutcome:
        rep = self.migrate(event.node, target)
        mech = rep.get("mechanism", rep["kind"])
        # bill the mechanism that actually moved the sub-job (hybrid
        # negotiates per event via Rules 1-3)
        rst_ev, ovh_ev = self._mech_costs(mech, self.period_s / 3600.0)
        if predicted:
            # moved during the lead window: nothing lost
            lost, reinstate = 0.0, self.micro.predict_s + rst_ev
        else:
            # blind failure: no byte-level checkpoint to restore — the
            # sub-job replays from its window-start progress mark
            lost, reinstate = float(event.t) - self._window_start(event.t), rst_ev
        return FailureOutcome(
            new_host=int(rep["to"]),
            lost_s=lost,
            reinstate_s=reinstate,
            overhead_s=ovh_ev,
            outcome="migrated",
            migrated=True,
            mechanism=mech,
            report=rep,
        )

    def on_prediction(self, event, target: int) -> FailureOutcome:
        return self._handle(event, target, predicted=True)

    def on_failure(self, event, target: int) -> FailureOutcome:
        return self._handle(event, target, predicted=False)


@register("agent")
class AgentStrategy(ProactiveStrategy):
    """Approach 1 — agent intelligence (software-layer migration)."""

    probe_mechanism = "agent"
    replay_mechanism = "agent"

    def _make_unit(self, host: int, payload: object):
        return Agent(host, host, payload, placement=self.placement)

    def _migrate_unit(self, unit, rt, target):
        return unit.migrate(rt, target)

    def _cost_mechanism(self, ctx: CostContext) -> str:
        return "agent"

    def _set_payload(self, unit, payload):
        unit.payload = payload


@register("core")
class CoreStrategy(ProactiveStrategy):
    """Approach 2 — virtual-core intelligence (runtime-level push)."""

    probe_mechanism = "core"
    replay_mechanism = "core"

    def _make_unit(self, host: int, payload: object):
        return VirtualCore(host, host, placement=self.placement)

    def _migrate_unit(self, unit, rt, target):
        return unit.migrate_job(rt, target)

    def _probe_unit(self, unit, rt) -> bool:
        return unit.self_probe(rt)

    def _cost_mechanism(self, ctx: CostContext) -> str:
        return "core"


@register("hybrid")
class HybridStrategy(ProactiveStrategy):
    """Approach 3 — agents ON virtual cores, negotiating per event via the
    empirically-derived Rules 1-3. Background probing runs on the core's
    cheap path; the agent/core split only matters per migration."""

    probe_mechanism = "core"
    replay_mechanism = "rules"

    def _make_unit(self, host: int, payload: object):
        return HybridUnit(
            Agent(host, host, payload, placement=self.placement),
            VirtualCore(host, host, placement=self.placement),
        )

    def _migrate_unit(self, unit, rt, target):
        return unit.handle_prediction(rt, target=target)

    def _cost_mechanism(self, ctx: CostContext) -> str:
        return decide(ctx.z, ctx.s_d_bytes, ctx.s_d_bytes).mechanism

    def _set_payload(self, unit, payload):
        unit.agent.payload = payload

    def _set_host(self, unit, host: int):
        unit.agent.host = unit.core.host = host
