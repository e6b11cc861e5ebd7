"""Event-driven campaign engine: drives the real FT machinery through an
arbitrary failure-event stream.

Where ``core/sim.py`` reproduces the paper's closed-form table accounting,
the engine *executes* a scenario: it resolves the approach through the
``repro_torch.strategies`` registry, attaches the strategy to a
:class:`ClusterRuntime` (the strategy places its Agent / VirtualCore /
HybridUnit — or checkpoint restore state — on every worker host), then
replays the spec's compiled trajectory tape in time order with

  * node blacklisting — a host that exceeds ``max_strikes`` failures (or
    any failure when ``repair_s`` is None) never hosts work again;
  * spare re-provisioning — repaired hosts rejoin the spare pool after a
    repair delay (constant, or sampled per repair from the spec's
    heavy-tailed ``("lognormal", mu, sigma)`` distribution);
  * dynamic cascades — a ``cascade`` event re-targets the host the victim
    migrated TO (unknowable at stream-generation time) and fails it
    ``delay_s`` later, down to ``depth`` levels;
  * network partitions — ``partition`` processes open/heal cluster cuts on
    the timeline (``ClusterRuntime.set_partition``); under the
    ``partition-aware`` placement policy migrations cannot cross the cut
    and minority components refuse placements (quorum);
  * spare-pool exhaustion — when the placement policy finds no healthy,
    un-blacklisted target the campaign is lost (``survived=False``,
    ``failed_at_s`` records when).

Event resolution is shared with the batched Monte-Carlo path: the
**trajectory compiler** (:mod:`repro_torch.scenarios.trajectory`) lowers the
spec's merged stream — cascade chains pre-allocated as parent-linked
slots, repair delays pre-sampled in schedule order, partition component
maps resolved per slot — and this engine folds the same tape through the
*real* runtime objects one trial at a time, while the batched replay
fold (torch, on the card) folds thousands of tapes at once. The engine is
the reference semantics; the fold is differentially tested against it
trial-for-trial.

The tick loop is strategy-agnostic: every per-approach decision — how to
move the work, what a failure costs, what background probing costs — goes
through the :class:`~repro_torch.strategies.base.FaultToleranceStrategy`
protocol (``on_prediction`` / ``on_failure`` / ``tick_costs``), so a
strategy registered anywhere immediately runs in campaigns.  Accounting
semantics per strategy are documented on the builtin adapters
(:mod:`repro_torch.strategies.builtin`).

It is detector-agnostic too: *whether* an event counts as predicted is no
longer read off the oracle ``ev.predictable`` bit but routed through a
registered :class:`~repro_torch.telemetry.detector.Detector` — the detector's
pre-sampled verdict tape (per-event draws in schedule order, the same
idiom as repair draws) decides ``on_prediction`` vs ``on_failure``, and
the identical tape feeds the batched replay fold, so engine and fold
stay trial-for-trial interchangeable under any detector. The default
``"oracle"`` detector reproduces the pre-refactor semantics bit-for-bit.
``degrade`` windows (a node slows its shard instead of dying) are billed
as extra synchronous-step time (:func:`~repro_torch.scenarios.spec.
degrade_slowdown_s`); a straggler-flagging detector mitigates them by
rebalancing work off the slow shard.

The *workload* is the third pluggable axis: ``workload=`` (or the spec's
declared ``ScenarioSpec.workload``) names a :mod:`repro_torch.workloads` model
whose calibrated micro-costs bill the campaign when no explicit
``micro`` is given. The default ``"analytic"`` workload resolves the
seed ``measure_micro`` record verbatim, keeping campaign records
byte-identical to the pre-workload-API engine.

The engine runs on the host. ``device`` says where the detector and the
workload it resolves from names compute (the ``ml`` detector trains its
predictor there, ``genome_search`` times its search there): the card
unless the caller asks for the CPU. With ``trace=True`` it records the
structured event timeline (:mod:`repro_torch.obs.trace`); a spec that
declares ``traffic`` is also billed for request-level SLOs
(:func:`repro_torch.traffic.slo.bill_slo`, host numpy).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.failure import FailureEvent
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.sim import MicroCosts
from repro_torch.scenarios.spec import ScenarioSpec, degrade_slowdown_s
from repro_torch.strategies import registry as strategy_registry
from repro_torch.telemetry import resolve as resolve_detector
from repro_torch.telemetry.detector import Detector
from repro_torch.workloads import Workload, resolve as resolve_workload


def __getattr__(name):
    # APPROACHES is derived live from the strategy registry so that
    # strategies registered after import are included.
    if name == "APPROACHES":
        return tuple(strategy_registry.names())
    raise AttributeError(name)


@dataclass
class CampaignResult:
    scenario: str
    approach: str
    survived: bool
    total_s: Optional[float]  # None when the campaign was lost
    failed_at_s: Optional[float]
    n_events: int
    n_handled: int
    n_migrations: int
    n_blacklisted: int
    n_reprovisioned: int
    lost_s: float
    reinstate_s: float
    overhead_s: float
    probe_s: float
    slowdown_s: float = 0.0  # degrade windows: extra synchronous-step time
    detector: str = "oracle"
    workload: str = "analytic"
    # request-level SLO billing (populated only when the spec declares a
    # traffic model; repro_torch.traffic.slo.bill_slo on both billing paths)
    autoscaler: Optional[str] = None
    slo_p50_s: Optional[float] = None
    slo_p99_s: Optional[float] = None
    slo_dropped: Optional[float] = None
    slo_availability: Optional[float] = None
    events: List[Dict] = field(default_factory=list)
    # populated only when the engine ran with trace=True; never serialised
    # by to_dict, so campaign records stay byte-identical
    trace: Optional[object] = None  # repro_torch.obs.trace.CampaignTrace

    def to_dict(self) -> Dict:
        d = {
            "scenario": self.scenario,
            "approach": self.approach,
            "survived": self.survived,
            "total_s": self.total_s,
            "failed_at_s": self.failed_at_s,
            "n_events": self.n_events,
            "n_handled": self.n_handled,
            "n_migrations": self.n_migrations,
            "n_blacklisted": self.n_blacklisted,
            "n_reprovisioned": self.n_reprovisioned,
            "lost_s": round(self.lost_s, 3),
            "reinstate_s": round(self.reinstate_s, 3),
            "overhead_s": round(self.overhead_s, 3),
            "probe_s": round(self.probe_s, 3),
        }
        # appended only when active, keeping the oracle/analytic campaign
        # records byte-identical to their pre-detector/workload-API form
        if self.slowdown_s:
            d["slowdown_s"] = round(self.slowdown_s, 3)
        if self.detector != "oracle":
            d["detector"] = self.detector
        if self.workload != "analytic":
            d["workload"] = self.workload
        if self.slo_availability is not None:
            d["autoscaler"] = self.autoscaler
            d["slo_p50_s"] = round(self.slo_p50_s, 6)
            d["slo_p99_s"] = round(self.slo_p99_s, 6)
            d["slo_dropped"] = round(self.slo_dropped, 3)
            d["slo_availability"] = round(self.slo_availability, 6)
        return d


class CampaignEngine:
    """Executes one scenario under one registered strategy."""

    def __init__(
        self,
        spec: ScenarioSpec,
        approach: str,
        profile: str = "placentia",
        micro: Optional[MicroCosts] = None,
        payload_elems: int = 1 << 10,
        seed: Optional[int] = None,
        placement: Optional[str] = None,
        detector: "str | Detector" = "oracle",
        workload: "str | Workload | None" = None,
        autoscaler: Optional[str] = None,
        trace: bool = False,
        device: str = "cuda",
    ):
        try:
            cls = strategy_registry.get_class(approach)
        except KeyError:
            raise ValueError(
                f"approach {approach!r}; one of {tuple(strategy_registry.names())}"
            ) from None
        self.spec = spec
        self.approach = cls.name  # canonical ("checkpoint" -> "central_single")
        self.profile = profile
        # explicit arg wins, then the spec's declared workload, then the
        # analytic anchor — whose micro is the seed measure_micro record
        # verbatim (memoized), keeping default campaigns byte-identical
        self.workload = resolve_workload(workload, spec, device=device)
        self.micro = micro or self.workload.micro(profile, n_nodes=spec.n_nodes)
        self.payload_elems = payload_elems
        self.seed = spec.seed if seed is None else seed
        # explicit arg wins, then the spec's declared policy, then the
        # strategy default (nearest-spare)
        self.placement = placement if placement is not None else spec.placement
        # which events count as predicted is the detector's call — the
        # oracle default reproduces the ev.predictable branch bit-for-bit
        self.detector = resolve_detector(detector, device)
        # capacity policy for request-level SLO billing (a repro_torch.traffic
        # registry name; None -> the traffic spec's declared default)
        self.autoscaler = autoscaler
        # structured event timeline (repro_torch.obs): opt-in, zero overhead off
        self.trace = bool(trace)

    # ------------------------------------------------------------------
    def _build(self) -> ClusterRuntime:
        spec = self.spec
        rt = ClusterRuntime(
            n_hosts=spec.n_nodes,
            n_spares=spec.n_spares,
            profile=self.profile,
            graph=DependencyGraph.star(spec.n_nodes - 1)
            if spec.n_nodes > 1
            else DependencyGraph(),
            seed=self.seed,
            racks=spec.effective_racks(),
        )
        self.strategy = strategy_registry.get(self.approach, placement=self.placement)
        payloads = {
            h: {"partial": np.full(self.payload_elems, h, np.float32), "cursor": h}
            for h in range(spec.n_nodes)
        }
        self.strategy.attach(rt, payloads, micro=self.micro, period_s=spec.period_s)
        return rt

    # ------------------------------------------------------------------
    def run(self) -> CampaignResult:
        from repro_torch.scenarios.trajectory import compile_tape

        spec = self.spec
        rt = self._build()
        strat = self.strategy
        tape = compile_tape(spec, self.seed)
        # per-event detector draws, pre-sampled in schedule order (exactly
        # like repair draws) — the replay fold consumes the same tape
        self.detector.bind(rt)
        verdicts, _leads = self.detector.verdict_tape(
            spec,
            times=tape.times,
            predictable=tape.predictable,
            rack_corr=tape.rack_corr,
            seed=self.seed,
        )
        oracle = self.detector.name == "oracle"
        # tracing off -> rec_ is None and every emit site is a single `if`
        rec_ = None
        if self.trace:
            from repro_torch.obs.trace import TraceRecorder

            rec_ = TraceRecorder()

        strikes: Dict[int, int] = {}
        pending: Dict[int, float] = {}  # host -> repair completion time
        fired_target: Dict[int, int] = {}  # slot -> where its sub-job landed
        draw_i = 0  # repair draws consumed in schedule order
        part_i = 0
        changes = tape.partition_changes
        res = CampaignResult(
            scenario=spec.name,
            approach=self.approach,
            survived=True,
            total_s=None,
            failed_at_s=None,
            n_events=0,
            n_handled=0,
            n_migrations=0,
            n_blacklisted=0,
            n_reprovisioned=0,
            lost_s=0.0,
            reinstate_s=0.0,
            overhead_s=0.0,
            probe_s=0.0,
            detector=self.detector.name,
            workload=self.workload.name,
        )

        for j in range(tape.n_slots):
            t = float(tape.times[j])
            if t >= spec.horizon_s:
                continue

            # partition cuts open/heal on the static timeline
            while part_i < len(changes) and changes[part_i][0] <= t:
                comp = changes[part_i][1]
                if comp is None:
                    rt.heal_partition()
                else:
                    rt.set_partition(comp)
                part_i += 1

            # repairs completing strictly before t rejoin the spare pool
            # in completion order
            for h, tr in sorted(pending.items(), key=lambda kv: (kv[1], kv[0])):
                if tr < t:
                    del pending[h]
                    if rt.provision_spare(h):
                        res.n_reprovisioned += 1
                        if rec_ is not None:  # timestamped at completion
                            rec_.emit(tr, "provision", node=h)

            # cascade children chase the host their parent's sub-job
            # migrated to — and only exist if it migrated at all
            parent = int(tape.parent[j])
            if parent >= 0:
                host = fired_target.get(parent)
                if host is None:
                    continue
            else:
                host = int(tape.victim[j])

            res.n_events += 1
            if not rt.healthy(host):
                continue  # already down — coalesced with an earlier event

            ev = FailureEvent(
                t=t,
                node=host,
                predictable=bool(tape.predictable[j]),
                cause=tape.causes[j],
                during_checkpoint=bool(tape.during_ckpt[j]),
            )
            if rec_ is not None:
                rec_.emit(t, "failure", node=host, cause=ev.cause, predictable=ev.predictable)
            strikes[host] = strikes.get(host, 0) + 1
            permanent = spec.repair_s is None or strikes[host] >= spec.max_strikes

            # telemetry: predictable failures degrade first (rack peers see
            # correlated drift through HeartbeatService.rack_stress)
            if ev.predictable:
                rt.heartbeats.mark_degrading(host)
            rt.heartbeats.tick()

            if strat.has_work(host):
                # never co-host two sub-jobs: only free targets are eligible
                target = strat.pick_target(host, require_free=True)
                if target is None:
                    # spare pool exhausted and no healthy peer: campaign lost
                    rt.fail(host, permanent=True)
                    res.survived = False
                    res.failed_at_s = float(t)
                    res.events.append(
                        {"t": float(t), "node": host, "cause": ev.cause, "outcome": "stranded"}
                    )
                    if rec_ is not None:
                        rec_.emit(t, "stranded", node=host)
                    break
                # the detector's verdict — not the oracle bit — decides
                # whether the strategy ACTS on a lead window; but a lead
                # window only exists if the node really emitted a degrading
                # signature (ev.predictable). A true positive migrates
                # ahead of the failure; a false claim on a no-signature
                # failure is handled blind AND pays the wasted prediction
                # work (the Fig 15c instability cost) — so a noisy
                # detector can never beat the oracle
                predicted = bool(verdicts[j])
                saved = predicted and ev.predictable
                out = (
                    strat.on_prediction(ev, target)
                    if saved and strat.proactive
                    else strat.on_failure(ev, target)
                )
                false_claim_s = (
                    self.micro.predict_s
                    if predicted and not saved and strat.proactive
                    else 0.0
                )
                res.lost_s += out.lost_s
                res.reinstate_s += out.reinstate_s + false_claim_s
                res.overhead_s += out.overhead_s
                res.n_handled += 1
                if out.migrated:
                    res.n_migrations += 1
                fired_target[j] = int(out.new_host)
                rec = {
                    "t": float(t),
                    "node": host,
                    "to": int(out.new_host),
                    "cause": ev.cause,
                    "predictable": bool(ev.predictable),
                    "outcome": out.outcome,
                }
                if not oracle:  # ground truth vs the detector's claim
                    rec["predicted"] = predicted
                res.events.append(rec)
                if rec_ is not None:
                    rec_.emit(
                        t,
                        "verdict",
                        node=host,
                        detector=self.detector.name,
                        predicted=predicted,
                        saved=bool(saved and strat.proactive),
                    )
                    rec_.emit(
                        t, "migrate", node=host, target=int(out.new_host), outcome=out.outcome
                    )

            rt.fail(host, permanent=permanent)
            if permanent:
                res.n_blacklisted += 1
                if rec_ is not None:
                    rec_.emit(t, "blacklist", node=host)
            elif spec.repair_s is not None:
                pending[host] = t + float(tape.repair_draws[draw_i])
                draw_i += 1

        if res.survived:
            # repairs still pending after the last event complete (and are
            # counted) if they land inside the horizon
            for h, tr in sorted(pending.items(), key=lambda kv: (kv[1], kv[0])):
                if tr < spec.horizon_s and rt.provision_spare(h):
                    res.n_reprovisioned += 1
                    if rec_ is not None:
                        rec_.emit(tr, "provision", node=h)

        # background probing accrues only while the campaign is running —
        # a lost campaign stops probing at failed_at_s
        probed_s = spec.horizon_s if res.survived else res.failed_at_s
        res.probe_s = strat.tick_costs() * (probed_s / 3600.0)

        # degrade windows: the slow shard paces every synchronous step; a
        # straggler-flagging detector rebalances work off it part-way in
        res.slowdown_s = degrade_slowdown_s(
            spec, mitigate_stragglers=self.detector.flags_stragglers
        )

        if res.survived:
            res.total_s = (
                spec.horizon_s
                + res.lost_s
                + res.reinstate_s
                + res.overhead_s
                + res.probe_s
                + res.slowdown_s
            )

        # request-level SLO billing: one shared deterministic function of
        # the compiled tape + verdicts, so the replay fold's per-seed
        # bill is bitwise identical (the degrade_slowdown_s idiom)
        if spec.traffic is not None:
            from repro_torch.core.rules import SD_THRESHOLD_BYTES
            from repro_torch.scenarios.trajectory import _payload_bytes
            from repro_torch.strategies.base import CostContext
            from repro_torch.traffic.slo import bill_slo

            bill = bill_slo(
                spec,
                times=tape.times,
                victim=tape.victim,
                parent=tape.parent,
                predictable=tape.predictable,
                verdicts=np.asarray(verdicts, bool),
                draws=tape.repair_draws,
                table=strat.cost_table(
                    CostContext(micro=self.micro, period_h=spec.period_s / 3600.0)
                ),
                wtable=self.workload.cost_table(self.profile, n_nodes=spec.n_nodes),
                seed=self.seed,
                autoscaler=self.autoscaler,
                rules_agent_small=_payload_bytes(self.payload_elems)
                <= SD_THRESHOLD_BYTES,
            )
            res.autoscaler = bill.autoscaler
            res.slo_p50_s = bill.p50_s
            res.slo_p99_s = bill.p99_s
            res.slo_dropped = bill.dropped
            res.slo_availability = bill.availability

        if rec_ is not None:
            from repro_torch.strategies.base import CostContext

            table = strat.cost_table(
                CostContext(micro=self.micro, period_h=spec.period_s / 3600.0)
            )
            res.trace = rec_.finalize(
                spec,
                approach=self.approach,
                seed=self.seed,
                detector=self.detector.name,
                workload=self.workload.name,
                survived=res.survived,
                failed_at_s=res.failed_at_s,
                mode_window=table.mode == "window",
                flags_stragglers=self.detector.flags_stragglers,
            )
        return res
