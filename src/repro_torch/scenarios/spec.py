"""Declarative scenario specs: a small dataclass/dict DSL for multi-failure
campaigns.

The paper evaluates exactly two single-node failure patterns (periodic and
random, Tables 1-2) and flags multi-failure refinements as future work.
Real clusters fail in correlated, cascading and repeated ways (Treaster's
survey; Mulone et al. 2407.05337), so a scenario here is a *composition of
failure processes* over a cluster layout:

    ScenarioSpec
      ├─ layout: n_nodes, n_spares, racks, checkpoint period, horizon
      └─ processes: [FailureProcessSpec, ...]   (merged into one stream)

Process kinds
-------------
  periodic        paper Table 1/2 periodic (offset after each window start)
  random          paper Table 1/2 random (uniform within each window)
  burst           k simultaneous failures on distinct nodes at time t
  rack            correlated rack-level outage: every node of one rack fails
                  within `spread_s` of the outage start
  cascade         a failure whose repair target also fails `delay_s` later
                  ("failure of the spare"), down to `depth` levels
  flaky           one repeat-offender node failing every `every_s`
  ckpt_window     failures timed to land *inside* checkpoint creation
                  (at k*period + epsilon)
  partition       network cut: opens at `t` and heals at `heal_t` (or
                  after `duration_s`); emits NO failure events — it
                  contributes host->component maps to the campaign
                  timeline (``partition_timeline``), which the engine
                  applies via ``ClusterRuntime.set_partition`` and the
                  ``partition-aware`` placement policy honours (quorum:
                  a minority component refuses placements)
  degrade         degrading-but-alive node: from `t` its relative speed
                  ramps down over `ramp_s` to `factor` and stays there
                  for `duration_s` — the node slows its shard instead of
                  dying. Emits NO failure events; it contributes slowdown
                  windows (``degrade_timeline``), which the engine and
                  the replay kernel account as extra synchronous-step
                  time (``degrade_slowdown_s`` via
                  ``core.straggler.sync_step_time``). Campaigns run under
                  a straggler-flagging detector mitigate the window by
                  rebalancing work off the slow shard.

Every process emits plain :class:`repro_torch.core.failure.FailureEvent` records —
the same event-stream interface the paper's :class:`FailureModel`
implements — so the engine, the closed-form accountant in ``core/sim.py``
and the Monte-Carlo layer all consume any scenario interchangeably.

Specs round-trip through dicts (``to_dict``/``from_dict``) so campaigns can
be written as JSON and shipped to the benchmark runner. ``repair_s`` is a
constant number of seconds or a heavy-tailed ``("lognormal", mu, sigma)``
spec sampled per repair (real repair times are lognormal).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.failure import (
    PREDICTABLE_FRACTION,
    FailureEvent,
    FailureModel,
)
from repro_torch.traffic.arrivals import TrafficSpec

PROCESS_KINDS = (
    "periodic",
    "random",
    "burst",
    "rack",
    "cascade",
    "flaky",
    "ckpt_window",
    "partition",
    "degrade",
)


@dataclass(frozen=True)
class FailureProcessSpec:
    kind: str
    params: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in PROCESS_KINDS:
            raise ValueError(f"unknown process kind {self.kind!r}; one of {PROCESS_KINDS}")


@dataclass
class ScenarioSpec:
    name: str
    n_nodes: int
    horizon_s: float
    n_spares: int = 2
    period_s: float = 3600.0  # checkpoint interval == failure-window length
    processes: List[FailureProcessSpec] = field(default_factory=list)
    racks: Optional[Dict[int, int]] = None  # node -> rack id
    # repair delay: None (failed nodes never return), a constant number of
    # seconds, or the heavy-tailed spec ("lognormal", mu, sigma) sampled
    # per repair (real repair times are lognormal — ROADMAP quick win)
    repair_s: Union[None, float, Tuple[str, float, float]] = None
    max_strikes: int = 3  # failures before a node is blacklisted for good
    predictable_fraction: float = PREDICTABLE_FRACTION
    # placement policy the campaign runs under (None -> the strategy's
    # default, nearest-spare). Partition scenarios set "partition-aware"
    # so migrations respect the cut.
    placement: Optional[str] = None
    # workload model the campaign is billed under (a repro_torch.workloads
    # registry name). "analytic" is the seed scalar cost model; calibrated
    # workloads (genome_search, train_llm, serve_decode, ...) price the
    # same failure stream from their own cost surfaces.
    workload: str = "analytic"
    seed: int = 0
    description: str = ""
    # set for the paper's two patterns so sim.py can take the exact
    # closed-form path (Tables 1-2 reproduce bit-for-bit):
    closed_form: Optional[str] = None  # "periodic" | "random" | None
    # offered request load (repro_torch.traffic): when set, campaigns on this
    # scenario are additionally billed in p50/p99 latency, dropped-request
    # and availability terms — identically by the engine and the replay
    # kernel (bill_slo is one shared deterministic function)
    traffic: Optional[TrafficSpec] = None

    # ------------------------------------------------------------------ DSL
    def to_dict(self) -> Dict:
        return asdict(self)  # recurses into the FailureProcessSpec list

    @staticmethod
    def from_dict(d: Dict) -> "ScenarioSpec":
        d = dict(d)
        d["processes"] = [
            p if isinstance(p, FailureProcessSpec) else FailureProcessSpec(**p)
            for p in d.get("processes", [])
        ]
        racks = d.get("racks")
        if racks is not None:
            d["racks"] = {int(k): int(v) for k, v in racks.items()}
        repair_s = d.get("repair_s")
        if isinstance(repair_s, (tuple, list)):  # JSON round-trips tuples as lists
            d["repair_s"] = (str(repair_s[0]), float(repair_s[1]), float(repair_s[2]))
        traffic = d.get("traffic")
        if traffic is not None and not isinstance(traffic, TrafficSpec):
            d["traffic"] = TrafficSpec.from_dict(traffic)
        return ScenarioSpec(**d)

    def sample_repair(self, rng: np.random.Generator) -> Optional[float]:
        """One repair delay in seconds: the constant, or a draw from the
        heavy-tailed ``("lognormal", mu, sigma)`` distribution."""
        r = self.repair_s
        if r is None:
            return None
        if isinstance(r, (tuple, list)):
            kind, mu, sigma = r
            if kind != "lognormal":
                raise ValueError(
                    f"unknown repair_s distribution {kind!r}; only 'lognormal'"
                )
            return float(rng.lognormal(float(mu), float(sigma)))
        return float(r)

    def effective_racks(self) -> Optional[Dict[int, int]]:
        """The rack layout both event generation AND the runtime's
        correlated telemetry use. When a `rack` process exists but no
        layout was given, a default pairwise layout is synthesised — from
        ONE place, so the engine's HeartbeatService sees the same racks the
        events were drawn from."""
        if self.racks is not None:
            return self.racks
        if any(p.kind == "rack" for p in self.processes):
            return {i: i % 2 for i in range(self.n_nodes)}
        return None

    # --------------------------------------------------- partition timeline
    def partition_timeline(self) -> List[Tuple[float, Optional[Dict[int, int]]]]:
        """Time-ordered cluster-cut changes from every ``partition`` process:
        ``[(t, {host: component})]`` when a cut opens, ``(t, None)`` when it
        heals. Deterministic (no rng), so the trajectory compiler can
        resolve the active component map per event slot statically.

        ``components`` defaults to one component per rack
        (``effective_racks``); spare hosts left unmapped share the
        "unmapped" component (``PartitionAware`` compares via
        ``dict.get``, so two unmapped hosts are mutually reachable)."""
        changes: List[Tuple[float, Optional[Dict[int, int]]]] = []
        for proc in self.processes:
            if proc.kind != "partition":
                continue
            p = proc.params
            t0 = float(p.get("t", 0.0))
            comps = p.get("components")
            if comps is None:
                comps = self.effective_racks() or {}
            comps = {int(k): int(v) for k, v in comps.items()}
            changes.append((t0, comps))
            heal_s = p.get("heal_t")
            if heal_s is None and p.get("duration_s") is not None:
                heal_s = t0 + float(p["duration_s"])
            if heal_s is not None:
                changes.append((float(heal_s), None))
        return sorted(changes, key=lambda c: c[0])

    # ---------------------------------------------------- degrade timeline
    def degrade_timeline(self) -> List[Tuple[float, float, int, float, float]]:
        """Slowdown windows from every ``degrade`` process:
        ``[(t0, t1, node, factor, ramp_s)]``, horizon-clipped and time-
        ordered. ``factor`` is the node's relative speed at full
        degradation (0 < factor <= 1); the ramp is linear over ``ramp_s``
        seconds from t0. Deterministic (no rng), so the engine and the
        batched replay path account the identical windows."""
        out: List[Tuple[float, float, int, float, float]] = []
        for proc in self.processes:
            if proc.kind != "degrade":
                continue
            p = proc.params
            t0 = float(p.get("t", 0.0))
            t1 = t0 + float(p.get("duration_s", self.horizon_s - t0))
            t1 = min(t1, self.horizon_s)
            factor = float(p.get("factor", 0.5))
            if not 0.0 < factor <= 1.0:
                raise ValueError(f"degrade factor must be in (0, 1], got {factor}")
            if t1 > t0:
                out.append(
                    (t0, t1, int(p.get("node", 0)), factor, float(p.get("ramp_s", 0.0)))
                )
        return sorted(out, key=lambda w: w[0])

    # ------------------------------------------------------- event stream
    def events(self, seed: Optional[int] = None) -> List[FailureEvent]:
        """Generate the merged, time-ordered failure stream for one trial."""
        base_seed = self.seed if seed is None else seed
        out: List[FailureEvent] = []
        kind_occurrence: Dict[str, int] = {}
        for i, proc in enumerate(self.processes):
            rng = np.random.default_rng((base_seed, i))
            occ = kind_occurrence.get(proc.kind, 0)
            kind_occurrence[proc.kind] = occ + 1
            out.extend(self._gen(proc, rng, base_seed, occ))
        # uniform horizon clip for every process kind (FailureModel clips
        # internally; burst/rack/cascade place events at explicit times)
        out = [e for e in out if e.t < self.horizon_s]
        return sorted(out, key=lambda e: e.t)

    def _gen(
        self, proc: FailureProcessSpec, rng: np.random.Generator, base_seed: int, idx: int
    ) -> List[FailureEvent]:
        p = proc.params
        if proc.kind == "partition":
            return []  # no failure events: contributes to partition_timeline()
        if proc.kind == "degrade":
            return []  # no failure events: contributes to degrade_timeline()
        if proc.kind in ("periodic", "random"):
            # delegate to the paper's FailureModel so the stream is
            # bit-for-bit the seed simulator's (same rng draw order). `idx`
            # counts prior processes of the SAME kind: the first periodic/
            # random process uses base_seed directly wherever it sits in
            # the list (paper exactness); repeats get a derived seed so
            # composing two `random` processes doubles the failures instead
            # of emitting the identical stream twice.
            fm = FailureModel(
                kind=proc.kind,
                n_nodes=self.n_nodes,
                horizon_s=self.horizon_s,
                period_s=p.get("period_s", self.period_s),
                offset_s=p.get("offset_s", 900.0),
                per_window=p.get("per_window", 1),
                seed=p.get("seed", base_seed + 1_000_003 * idx),
                predictable_fraction=p.get(
                    "predictable_fraction", self.predictable_fraction
                ),
            )
            return fm.events()

        if proc.kind == "burst":
            t = float(p.get("t", self.period_s / 2))
            k = int(p.get("k", min(3, self.n_nodes)))
            nodes = rng.choice(self.n_nodes, size=min(k, self.n_nodes), replace=False)
            return [
                FailureEvent(
                    t=t + 1e-3 * j,  # strictly ordered, effectively simultaneous
                    node=int(n),
                    predictable=bool(rng.random() < self.predictable_fraction),
                    cause="burst",
                )
                for j, n in enumerate(nodes)
            ]

        if proc.kind == "rack":
            racks = self.effective_racks()
            rack_id = p.get("rack")
            if rack_id is None:
                rack_id = int(rng.choice(sorted(set(racks.values()))))
            members = [n for n, r in racks.items() if r == rack_id and n < self.n_nodes]
            t0 = float(p.get("t", self.period_s / 2))
            spread_s = float(p.get("spread_s", 60.0))
            return [
                FailureEvent(
                    t=t0 + float(rng.uniform(0.0, spread_s)),
                    node=int(n),
                    predictable=bool(rng.random() < self.predictable_fraction),
                    cause="rack",
                    rack=int(rack_id),
                )
                for n in members
            ]

        if proc.kind == "cascade":
            t = float(p.get("t", self.period_s / 2))
            node = int(p.get("node", rng.integers(0, self.n_nodes)))
            return [
                FailureEvent(
                    t=t,
                    node=node,
                    predictable=bool(
                        p.get("predictable", rng.random() < self.predictable_fraction)
                    ),
                    cause="cascade",
                    cascade={
                        "delay_s": float(p.get("delay_s", 120.0)),
                        "depth": int(p.get("depth", 1)),
                    },
                )
            ]

        if proc.kind == "flaky":
            node = int(p.get("node", rng.integers(0, self.n_nodes)))
            every_s = float(p.get("every_s", self.period_s / 2))
            if every_s <= 0:
                raise ValueError(f"flaky every_s must be > 0, got {every_s}")
            t = float(p.get("first_t", every_s))
            out = []
            while t < self.horizon_s:
                out.append(
                    FailureEvent(
                        t=t,
                        node=node,
                        predictable=bool(rng.random() < self.predictable_fraction),
                        cause="flaky",
                    )
                )
                t += every_s
            return out

        if proc.kind == "ckpt_window":
            # fires while the checkpoint at k*period is being created
            eps = float(p.get("offset_s", 5.0))
            which = p.get("windows")  # list of window indices, default: all
            n_ck = int(np.floor(self.horizon_s / self.period_s))
            windows = which if which is not None else list(range(1, n_ck + 1))
            return [
                FailureEvent(
                    t=k * self.period_s + eps,
                    node=int(rng.integers(0, self.n_nodes)),
                    predictable=False,  # mid-checkpoint failures strike blind
                    cause="ckpt_window",
                    during_checkpoint=True,
                )
                for k in windows
                if k * self.period_s + eps < self.horizon_s
            ]

        raise ValueError(proc.kind)  # unreachable: __post_init__ validates


def degrade_slowdown_s(
    spec: "ScenarioSpec",
    mitigate_stragglers: bool = False,
    mitigate_after_s: float = 120.0,
    mitigate_factor: float = 0.5,
    dt_s: float = 30.0,
    shard_units: int = 8,
) -> float:
    """Extra synchronous-step seconds a campaign pays for its ``degrade``
    windows — the engine accounting for slowdown (not just loss).

    In an SPMD step the slowest host sets the pace: with uniform shards
    the step-time multiplier is ``sync_step_time(split, speeds)`` where
    the degraded node's speed ramps from 1 down to ``factor``. The extra
    time is the integral of ``multiplier - 1`` over each window (midpoint
    rule on a ``dt_s`` grid — deterministic, so the Python engine and the
    batched replay path bill the identical amount).

    ``mitigate_stragglers=True`` (a straggler-flagging detector is
    driving the campaign): from ``mitigate_after_s`` into the window the
    flagged node's shard is rebalanced off it
    (:func:`repro_torch.core.straggler.mitigate`), shrinking the multiplier —
    detection quality visibly buys step time."""
    from repro_torch.core.straggler import mitigate, sync_step_time

    windows = spec.degrade_timeline()
    if not windows:
        return 0.0
    n = spec.n_nodes
    base = [shard_units] * n
    extra = 0.0
    for t0, t1, node, factor, ramp_s in windows:
        if not 0 <= node < n:
            raise ValueError(f"degrade node {node} outside 0..{n - 1}")
        mitigated = (
            mitigate(base, [node], factor=mitigate_factor) if mitigate_stragglers else base
        )
        t = t0
        while t < t1:
            step = min(dt_s, t1 - t)
            tm = t + 0.5 * step  # midpoint
            frac = 1.0 if ramp_s <= 0 else min(1.0, (tm - t0) / ramp_s)
            speeds = np.ones(n)
            speeds[node] = 1.0 - (1.0 - factor) * frac
            split = mitigated if (mitigate_stragglers and tm >= t0 + mitigate_after_s) else base
            extra += (sync_step_time(split, speeds) - 1.0) * step
            t += step
    return float(extra)
