"""Structured campaign traces: typed timeline events from the engine, and
an exact reconstruction of the same timeline from the batched replay
fold's per-slot records and the compiled tapes.

The repo's accounting has always ended in scalars — a campaign totals
``lost + reinstate + overhead + probe`` and reports the sum. Monitoring
is the substrate every recovery technique stands on (Treaster,
cs/0501002), and any tuner acting on the system needs per-component,
per-instant visibility (Roy et al., 1005.2027): *when* did each FT
decision fire, on which node, claimed by which detector, and what did it
displace. A :class:`CampaignTrace` is that record — a time-ordered list
of :class:`TraceEvent` rows.

Two producers, one invariant:

**engine** — :class:`~repro_torch.scenarios.engine.CampaignEngine` run with
``trace=True`` emits events at every decision point of its tick loop
(zero overhead when disabled: the recorder is ``None`` and every emit
site is a single ``if``).

**kernel** (the replay fold; the reference's name for the source is
kept) — :func:`reconstruct_traces` derives the identical timeline
from the batched replay fold's per-slot output arrays
(``replay_batch(..., record_slots=True)``) plus the compiled tape's
static data (causes, schedules, partition/degrade timelines). This
extends the repo's trial-for-trial parity idiom from aggregate counters
to the event level: the differential tests assert engine-trace ≡
kernel-trace event-for-event per seed.

Event kinds
-----------
===================  ====================================================
``failure``          a failure event landed on a live node (cause,
                     ground-truth predictability in ``meta``)
``verdict``          the detector's call on a handled failure
                     (``predicted``: the claim; ``saved``: claim ∧ real
                     lead window ∧ proactive strategy — the migration
                     actually beat the failure)
``migrate``          the strategy moved/restored/restarted the sub-job
                     (``target`` = new host, ``outcome`` per billing
                     mode: migrated / restored / restarted)
``blacklist``        the node exceeded its strikes and never hosts again
``provision``        a repaired node rejoined the spare pool (timestamped
                     at repair *completion*)
``stranded``         no healthy target existed — campaign lost here
``ckpt_write``       checkpoint cadence marker (window-mode strategies),
                     every ``period_s`` inside the billed span
``partition_open``/  a network cut opened / healed on the static
``partition_heal``   campaign timeline
``degrade``          a slowdown window opened (factor, ramp, until, and
                     whether a straggler-flagging detector mitigates it)
===================  ====================================================

Ordering is deterministic: events sort by ``(t, kind-priority, node,
target)``, and both producers apply the same sort, so list equality is
the parity criterion.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "TraceEvent",
    "CampaignTrace",
    "TraceRecorder",
    "outage_windows",
    "reconstruct_traces",
    "MODE_OUTCOME",
]

#: deterministic within-timestamp ordering (schedule markers first, then
#: the failure-handling sequence as the engine executes it)
_KIND_ORDER = {
    "ckpt_write": 0,
    "partition_open": 1,
    "partition_heal": 2,
    "degrade": 3,
    "provision": 4,
    "failure": 5,
    "verdict": 6,
    "migrate": 7,
    "blacklist": 8,
    "stranded": 9,
    # trainer-side: work redistributed across survivors (straggler
    # mitigation, elastic shrink) — not produced by campaign replays
    "rebalance": 10,  # repro: ignore[parity-coverage]
}

#: billing mode -> the builtin strategies' FailureOutcome.outcome string
#: (window restores from checkpoint, proactive migrates live state, cold
#: restarts from scratch) — what the kernel-side reconstruction stamps on
#: ``migrate`` events, since the compiled path never materialises
#: FailureOutcome objects
MODE_OUTCOME = {"window": "restored", "proactive": "migrated", "cold": "restarted"}


def _norm(v):
    """Metadata values normalised to plain Python scalars so engine- and
    kernel-produced events compare equal (numpy bools/floats unboxed)."""
    if isinstance(v, (np.generic,)):
        v = v.item()
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return float(v)
    return v


@dataclass(frozen=True)
class TraceEvent:
    """One typed instant on a campaign timeline (hashable, comparable)."""

    t: float
    kind: str
    node: int = -1
    target: int = -1
    meta: Tuple[Tuple[str, object], ...] = ()

    @classmethod
    def make(cls, t, kind: str, node: int = -1, target: int = -1, **meta) -> "TraceEvent":
        if kind not in _KIND_ORDER:
            raise ValueError(f"unknown trace event kind {kind!r}; one of {tuple(_KIND_ORDER)}")
        return cls(
            t=float(t),
            kind=kind,
            node=int(node),
            target=int(target),
            meta=tuple(sorted((k, _norm(v)) for k, v in meta.items())),
        )

    def arg(self, key: str, default=None):
        for k, v in self.meta:
            if k == key:
                return v
        return default

    def sort_key(self):
        return (self.t, _KIND_ORDER[self.kind], self.node, self.target)

    def to_dict(self) -> Dict:
        d = {"t": self.t, "kind": self.kind}
        if self.node >= 0:
            d["node"] = self.node
        if self.target >= 0:
            d["target"] = self.target
        d.update({k: v for k, v in self.meta})
        return d


@dataclass
class CampaignTrace:
    """One campaign's full event timeline plus its identifying header."""

    scenario: str
    approach: str
    seed: int
    detector: str
    workload: str
    source: str  # "engine" | "kernel"
    survived: bool
    horizon_s: float
    end_s: float  # failed_at_s when lost, else horizon_s
    n_hosts: int
    events: List[TraceEvent] = field(default_factory=list)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def select(self, kind: str) -> List[TraceEvent]:
        return [ev for ev in self.events if ev.kind == kind]

    def comparable(self) -> Dict:
        """Everything the engine≡kernel differential compares (the
        ``source`` tag is the one field allowed to differ)."""
        return {
            "scenario": self.scenario,
            "approach": self.approach,
            "seed": self.seed,
            "detector": self.detector,
            "workload": self.workload,
            "survived": self.survived,
            "end_s": self.end_s,
            "events": self.events,
        }

    def to_dict(self) -> Dict:
        return {
            "scenario": self.scenario,
            "approach": self.approach,
            "seed": self.seed,
            "detector": self.detector,
            "workload": self.workload,
            "source": self.source,
            "survived": self.survived,
            "horizon_s": self.horizon_s,
            "end_s": self.end_s,
            "n_hosts": self.n_hosts,
            "events": [ev.to_dict() for ev in self.events],
        }


def outage_windows(trace: "CampaignTrace") -> List[Tuple[int, float, float]]:
    """Per-host down windows ``(node, down_s, up_s)`` from a trace.

    Each ``failure`` event opens a window on its node; the node's next
    ``provision`` event closes it. A host that never comes back (failure
    with no later provision — blacklisted, stranded, or the campaign
    ended first) stays down until ``end_s``. This is the serving-side
    view of a trace: the same intervals the SLO biller charges as shard
    outages, exposed for inspection and plotting."""
    open_at: Dict[int, float] = {}
    windows: List[Tuple[int, float, float]] = []
    for ev in sorted(trace.events, key=TraceEvent.sort_key):
        if ev.kind == "failure" and ev.node not in open_at:
            open_at[ev.node] = ev.t
        elif ev.kind == "provision" and ev.node in open_at:
            windows.append((ev.node, open_at.pop(ev.node), ev.t))
    for node, down_s in open_at.items():
        windows.append((node, down_s, float(trace.end_s)))
    windows.sort(key=lambda w: (w[1], w[0]))
    return windows


def schedule_events(
    spec, end_s: float, mode_window: bool, flags_stragglers: bool
) -> List[TraceEvent]:
    """Events derivable from the spec's *static* timelines alone, clipped
    to the billed span ``[0, end_s)``: checkpoint cadence markers,
    partition opens/heals, degrade windows. One shared helper — the
    engine recorder and the kernel reconstruction both call it, so these
    rows are identical by construction."""
    out: List[TraceEvent] = []
    if mode_window and spec.period_s > 0:
        k = 1
        while k * spec.period_s < end_s:
            out.append(TraceEvent.make(k * spec.period_s, "ckpt_write"))
            k += 1
    for t, comp in spec.partition_timeline():
        if t >= end_s:
            continue
        if comp is None:
            out.append(TraceEvent.make(t, "partition_heal"))
        else:
            out.append(
                TraceEvent.make(t, "partition_open", n_components=len(set(comp.values())))
            )
    for t0, t1, node, factor, ramp_s in spec.degrade_timeline():
        if t0 >= end_s:
            continue
        out.append(
            TraceEvent.make(
                t0,
                "degrade",
                node=node,
                factor=factor,
                ramp_s=ramp_s,
                until_s=min(t1, end_s),
                mitigated=flags_stragglers,
            )
        )
    return out


class TraceRecorder:
    """Collects :class:`TraceEvent` rows during one campaign.

    The engine holds ``None`` instead of a recorder when tracing is off,
    so the disabled path costs one ``if`` per emit site and allocates
    nothing."""

    def __init__(self):
        self.events: List[TraceEvent] = []

    def emit(self, t, kind: str, node: int = -1, target: int = -1, **meta):
        self.events.append(TraceEvent.make(t, kind, node=node, target=target, **meta))

    def finalize(
        self,
        spec,
        *,
        approach: str,
        seed: int,
        detector: str,
        workload: str,
        survived: bool,
        failed_at_s: Optional[float],
        mode_window: bool,
        flags_stragglers: bool,
        source: str = "engine",
    ) -> CampaignTrace:
        end_s = float(spec.horizon_s if survived else failed_at_s)
        events = self.events + schedule_events(spec, end_s, mode_window, flags_stragglers)
        events.sort(key=TraceEvent.sort_key)
        return CampaignTrace(
            scenario=spec.name,
            approach=approach,
            seed=int(seed),
            detector=detector,
            workload=workload,
            source=source,
            survived=bool(survived),
            horizon_s=float(spec.horizon_s),
            end_s=end_s,
            n_hosts=int(spec.n_nodes + spec.n_spares),
            events=events,
        )


# ======================================================================
# Fold-side reconstruction
# ======================================================================
def reconstruct_traces(
    spec,
    strategy,
    n_seeds: int = 1,
    base_seed: int = 0,
    *,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    detector="oracle",
    workload=None,
    device="cuda",
) -> List[CampaignTrace]:
    """Derive per-seed :class:`CampaignTrace` timelines from the batched
    replay fold, without running the Python engine.

    One ``replay_batch(..., record_slots=True)`` call evaluates every
    seed's campaign in the torch fold on ``device`` (the card unless the
    caller asks for the CPU); the per-slot output
    arrays (processed / handled / resolved victim / target / blacklist /
    repair schedule / strand) plus the tape's static columns (times,
    causes, predictability, verdict draws) are then folded into the same
    typed events the engine emits, under the same deterministic sort.
    For the builtin strategies this is *exact* — the differential tests
    assert list equality against ``CampaignEngine(..., trace=True)``
    trial-for-trial. (Custom strategies whose ``FailureOutcome.outcome``
    strings deviate from their billing mode's — see :data:`MODE_OUTCOME`
    — would differ only in that metadata field.)"""
    from repro_torch.scenarios.trajectory import compile_batch, compile_tape, replay_batch
    from repro_torch.strategies import registry as strategy_registry
    from repro_torch.strategies.base import CostContext, FaultToleranceStrategy
    from repro_torch.telemetry import resolve as resolve_detector
    from repro_torch.workloads import resolve as resolve_workload

    strat = (
        strategy
        if isinstance(strategy, FaultToleranceStrategy)
        else strategy_registry.get(strategy)
    )
    det = resolve_detector(detector, device)
    wl = resolve_workload(workload, spec, device=device)
    if micro is None:
        micro = wl.micro(profile, n_nodes=spec.n_nodes)

    batch = compile_batch(spec, n_seeds, base_seed=base_seed)
    tapes = [compile_tape(spec, base_seed + s) for s in range(n_seeds)]
    out = replay_batch(
        spec,
        batch,
        strat,
        micro=micro,
        profile=profile,
        placement=placement,
        detector=det,
        workload=wl,
        record_slots=True,
        device=device,
    )
    table = strat.cost_table(CostContext(micro=micro, period_h=spec.period_s / 3600.0))
    outcome = MODE_OUTCOME[table.mode]

    traces: List[CampaignTrace] = []
    for s, tape in enumerate(tapes):
        survived = bool(out["survived"][s])
        failed_at = None if survived else float(out["failed_at_s"][s])
        end_s = spec.horizon_s if survived else failed_at
        rec = TraceRecorder()
        processed = out["slot_processed"][s]
        handled = out["slot_handled"][s]
        victim = out["slot_victim"][s]
        target = out["slot_target"][s]
        blacklisted = out["slot_blacklisted"][s]
        repair_sched = out["slot_repair_sched"][s]
        repair_at = out["slot_repair_at"][s]
        stranded = out["slot_stranded"][s]
        verdicts = out["slot_verdict"][s]
        for j in range(tape.n_slots):
            if not processed[j]:
                continue
            t = float(tape.times[j])
            node = int(victim[j])
            rec.emit(
                t,
                "failure",
                node=node,
                cause=tape.causes[j],
                predictable=bool(tape.predictable[j]),
            )
            if stranded[j]:
                rec.emit(t, "stranded", node=node)
                continue
            if handled[j]:
                predicted = bool(verdicts[j])
                saved = bool(predicted and tape.predictable[j] and strat.proactive)
                rec.emit(
                    t, "verdict", node=node, detector=det.name, predicted=predicted, saved=saved
                )
                rec.emit(t, "migrate", node=node, target=int(target[j]), outcome=outcome)
            if blacklisted[j]:
                rec.emit(t, "blacklist", node=node)
            if repair_sched[j]:
                tr = float(repair_at[j])
                if tr < end_s:  # rejoined before the billed span closed
                    rec.emit(tr, "provision", node=node)
        traces.append(
            rec.finalize(
                spec,
                approach=strat.name,
                seed=base_seed + s,
                detector=det.name,
                workload=wl.name,
                survived=survived,
                failed_at_s=failed_at,
                mode_window=table.mode == "window",
                flags_stragglers=det.flags_stragglers,
                source="kernel",
            )
        )
    return traces
