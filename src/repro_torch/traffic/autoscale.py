"""The built-in autoscaling policies: capacity plans over a campaign.

An :class:`Autoscaler` turns a :class:`~repro_torch.traffic.slo.ServingTimeline`
— the per-interval serving state the SLO biller distils from one trial's
control flow (live shards, recovery outages, degrade windows, free
spares) — into a :class:`CapacityPlan`: the requests-per-second the
fleet can retire in each accounting interval. Capacity policy is thereby
a pluggable axis orthogonal to the FT strategy, echoing the multi-agent
performance-tuning framing of arXiv 1005.2027 where adaptation itself is
an agent.

Three registrations — the matrix rows of the benchmark's traffic
report, in registration order:

``static``
    today's behaviour: the fleet holds its provisioned shard count;
    every handled failure takes one shard-equivalent out for its
    recovery outage, and a stranded campaign stops serving entirely.

``shrink_to_fit``
    elastic shard counts: instead of waiting on a spare, the fleet
    re-shards onto the survivors — fewer, slower shards priced from the
    workload's ``step_time(n_shards)`` surface, with each re-shard
    paying a ``rebalance_shard_s`` outage. The fleet never dies: a
    stranded slot retires its shard permanently instead of killing the
    campaign.

``burst_scale_out``
    static, plus proactive capacity: when the offered rate crosses the
    current capacity, idle spares from the pool are provisioned as extra
    serving shards with a one-interval activation lag.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.traffic.registry import register


@dataclass(frozen=True)
class CapacityPlan:
    """One policy's per-interval serving capacity for one trial."""

    capacity_rps: np.ndarray  # float64 [n_intervals]
    # per-interval single-request service seconds (one synchronous step at
    # the fleet size the policy runs); None -> step_time at n_shards0
    service_s: Optional[np.ndarray] = None
    n_rebalances: int = 0  # shrink re-shard events billed
    n_scaleouts: int = 0  # spare shards provisioned by scale-out


class Autoscaler(ABC):
    """Base class for every capacity policy.

    ``continue_after_strand`` feeds back into the SLO control-flow
    replay: policies that re-shard around a stranded slot (no spare, no
    neighbour) keep the campaign serving at reduced capacity where the
    makespan accounting would declare it dead. The flag must be a class
    attribute — it participates in engine/fold billing parity."""

    name: str = "?"
    description: str = ""
    continue_after_strand: bool = False

    @abstractmethod
    def plan(self, tl: "ServingTimeline") -> CapacityPlan:  # noqa: F821
        """Per-interval capacity for one trial's serving timeline."""

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


@register("static")
class StaticFleet(Autoscaler):
    """Fixed shard count; recovery outages and death bite directly."""

    description = "fixed fleet: outages subtract capacity, stranding kills it"

    def plan(self, tl) -> CapacityPlan:
        k0 = float(tl.n_shards0)
        k_eff = np.maximum(k0 - tl.outage_shard_ivs - tl.degrade_shard_ivs, 0.0)
        cap = k_eff * tl.per_shard_rps(k0) * tl.alive_frac
        return CapacityPlan(capacity_rps=cap)


@register("shrink_to_fit")
class ShrinkToFit(Autoscaler):
    """Re-shard onto the survivors: fewer, slower shards, but never dead."""

    description = "elastic re-shard onto survivors (step_time surface pricing)"
    continue_after_strand = True

    def plan(self, tl) -> CapacityPlan:
        k_live = tl.live_shard_ivs
        k_eff = np.maximum(k_live - tl.rebalance_shard_ivs - tl.degrade_shard_ivs, 0.0)
        cap = k_eff * tl.per_shard_rps(np.maximum(k_live, 1.0))
        return CapacityPlan(
            capacity_rps=cap,
            service_s=tl.step_s_at(np.maximum(k_live, 1.0)),
            n_rebalances=tl.n_shrink_events,
        )


@register("burst_scale_out")
class BurstScaleOut(Autoscaler):
    """Static, plus idle spares provisioned when offered load crosses
    capacity (one accounting interval of activation lag)."""

    description = "provision idle spares when offered rate crosses capacity"

    def plan(self, tl) -> CapacityPlan:
        k0 = float(tl.n_shards0)
        per_rps = float(tl.per_shard_rps(k0))
        base = (
            np.maximum(k0 - tl.outage_shard_ivs - tl.degrade_shard_ivs, 0.0)
            * per_rps
            * tl.alive_frac
        )
        n = base.shape[0]
        cap = np.zeros(n, np.float64)
        extra = 0
        n_scaleouts = 0
        for i in range(n):
            cap[i] = base[i] + extra * per_rps * tl.alive_frac[i]
            offered_rps = tl.counts[i] / tl.width_s[i] if tl.width_s[i] > 0 else 0.0
            short_rps = offered_rps - cap[i]
            want = int(np.ceil(short_rps / per_rps)) if short_rps > 0 else 0
            # decisions made at interval i take effect at i + 1 (lag);
            # provisioned spares are released as soon as load subsides
            grown = min(max(want, 0), int(tl.pool_free[i]))
            if grown > extra:
                n_scaleouts += grown - extra
            extra = grown
        return CapacityPlan(capacity_rps=cap, n_scaleouts=n_scaleouts)
