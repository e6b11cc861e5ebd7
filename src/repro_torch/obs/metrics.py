"""Metric frames: per-campaign time-in-state accounting and cross-seed
aggregation.

A campaign's billed total has always been one scalar; a
:class:`MetricFrame` is the same number *decomposed* into the states the
paper argues about — compute (the horizon's useful work), lost
(recomputation after failures), migrate (reinstatement work), ckpt
(per-event overhead: checkpoint writes, agent bring-up), and stall
(background probing + degrade slowdown). The decomposition **sums to the
billed total by construction**: :meth:`MetricFrame.total_s` adds the
components in the exact order the engine adds them
(``horizon + lost + reinstate + overhead + probe + slowdown``), so the
equality is bitwise, not approximate — the invariant the obs tests
assert for every builtin strategy × workload.

Frames are produced from either execution layer (the Python engine's
:class:`~repro_torch.scenarios.engine.CampaignResult` via
:func:`frame_from_result`, or the replay kernel's batched output via
:func:`frames_from_replay`) and aggregated across seeds into p5/p50/p95
distributions per (family × strategy × workload × detector) by
:func:`aggregate_frames` — the summary ``mc_trajectories`` now attaches
to every run.

Traces feed two further views: :func:`availability_timeline` (the
fraction of hosts up over time, from failure/provision events) and
:func:`verdict_ledger` (per-detector claim accounting: true saves,
false claims, blind handles)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MetricFrame",
    "frame_from_result",
    "frames_from_replay",
    "aggregate_frames",
    "aggregate_slo",
    "availability_timeline",
    "verdict_ledger",
]

#: the stacked-breakdown components, in the engine's addition order
COMPONENTS = ("compute_s", "lost_s", "migrate_s", "ckpt_s", "probe_s", "slowdown_s")


@dataclass(frozen=True)
class MetricFrame:
    """One campaign's billed total, decomposed into time-in-state.

    Field semantics (all seconds):

    ``compute_s``   the horizon — useful work the campaign was billed for
    ``lost_s``      recomputation: work redone after failures
    ``migrate_s``   reinstatement: moving/restoring sub-jobs (plus false-
                    claim prediction work under noisy detectors)
    ``ckpt_s``      per-event overhead: checkpoint writes, agent bring-up
    ``probe_s``     background probing while the campaign ran
    ``slowdown_s``  degrade windows pacing the synchronous step
    """

    scenario: str
    approach: str
    detector: str
    workload: str
    seed: int
    survived: bool
    compute_s: float
    lost_s: float
    migrate_s: float
    ckpt_s: float
    probe_s: float
    slowdown_s: float
    billed_total_s: Optional[float]  # engine/kernel total_s (None when lost)
    failed_at_s: Optional[float] = None

    def total_s(self) -> Optional[float]:
        """The breakdown re-summed in the engine's exact addition order —
        bitwise equal to ``billed_total_s`` for surviving campaigns."""
        if not self.survived:
            return None
        return (
            self.compute_s
            + self.lost_s
            + self.migrate_s
            + self.ckpt_s
            + self.probe_s
            + self.slowdown_s
        )

    @property
    def stall_s(self) -> float:
        return self.probe_s + self.slowdown_s

    @property
    def overhead_frac(self) -> Optional[float]:
        """Overhead over useful work — the paper's headline percentage."""
        if not self.survived or self.compute_s <= 0:
            return None
        return (self.total_s() - self.compute_s) / self.compute_s

    def breakdown(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in COMPONENTS}

    def to_dict(self) -> Dict:
        d = {
            "scenario": self.scenario,
            "approach": self.approach,
            "detector": self.detector,
            "workload": self.workload,
            "seed": self.seed,
            "survived": self.survived,
            **{k: round(getattr(self, k), 6) for k in COMPONENTS},
        }
        if self.survived:
            d["billed_total_s"] = self.billed_total_s
            d["overhead_frac"] = round(self.overhead_frac, 6)
        else:
            d["failed_at_s"] = self.failed_at_s
        return d


def frame_from_result(spec, result, seed: Optional[int] = None) -> MetricFrame:
    """Decompose one engine :class:`~repro_torch.scenarios.engine.CampaignResult`.

    The mapping is 1:1 with the result's accumulators (``reinstate_s`` →
    migrate, ``overhead_s`` → ckpt), so the frame's :meth:`~MetricFrame.
    total_s` reproduces ``result.total_s`` exactly."""
    return MetricFrame(
        scenario=result.scenario,
        approach=result.approach,
        detector=result.detector,
        workload=result.workload,
        seed=int(spec.seed if seed is None else seed),
        survived=bool(result.survived),
        compute_s=float(spec.horizon_s),
        lost_s=float(result.lost_s),
        migrate_s=float(result.reinstate_s),
        ckpt_s=float(result.overhead_s),
        probe_s=float(result.probe_s),
        slowdown_s=float(result.slowdown_s),
        billed_total_s=None if result.total_s is None else float(result.total_s),
        failed_at_s=None if result.failed_at_s is None else float(result.failed_at_s),
    )


def frames_from_replay(
    spec,
    out: Dict[str, np.ndarray],
    approach: str,
    *,
    detector: str = "oracle",
    workload: str = "analytic",
    base_seed: int = 0,
) -> List[MetricFrame]:
    """Decompose every seed of a ``replay_batch`` output dict.

    The kernel accumulates the same components in the same f64 order, so
    each frame's :meth:`~MetricFrame.total_s` equals the kernel's
    ``total_s`` entry bitwise (NaN totals — lost campaigns — map to
    ``None``)."""
    n = len(out["survived"])
    frames = []
    for s in range(n):
        survived = bool(out["survived"][s])
        frames.append(
            MetricFrame(
                scenario=spec.name,
                approach=approach,
                detector=detector,
                workload=workload,
                seed=base_seed + s,
                survived=survived,
                compute_s=float(spec.horizon_s),
                lost_s=float(out["lost_s"][s]),
                migrate_s=float(out["reinstate_s"][s]),
                ckpt_s=float(out["overhead_s"][s]),
                probe_s=float(out["probe_s"][s]),
                slowdown_s=float(out["slowdown_s"][s]),
                billed_total_s=float(out["total_s"][s]) if survived else None,
                failed_at_s=None if survived else float(out["failed_at_s"][s]),
            )
        )
    return frames


def aggregate_frames(frames: Sequence[MetricFrame]) -> Dict:
    """Cross-seed distribution summary for one (family × strategy ×
    workload × detector) cell: p5/p50/p95 + mean per component over the
    surviving campaigns, survival rate, and the overhead fraction the
    paper's tables report."""
    frames = list(frames)
    alive = [f for f in frames if f.survived]
    out: Dict = {
        "n_seeds": len(frames),
        "n_survived": len(alive),
        "survival_rate": round(len(alive) / len(frames), 4) if frames else 0.0,
    }
    if frames:
        f0 = frames[0]
        out.update(
            scenario=f0.scenario,
            approach=f0.approach,
            detector=f0.detector,
            workload=f0.workload,
        )
    if alive:
        cols = {k: np.asarray([getattr(f, k) for f in alive]) for k in COMPONENTS}
        cols["stall_s"] = np.asarray([f.stall_s for f in alive])
        cols["total_s"] = np.asarray([f.total_s() for f in alive])
        cols["overhead_frac"] = np.asarray([f.overhead_frac for f in alive])
        dist = {}
        for k, v in cols.items():
            p5, p50, p95 = np.percentile(v, [5.0, 50.0, 95.0])
            dist[k] = {
                "mean": round(float(np.mean(v)), 4),
                "p5": round(float(p5), 4),
                "p50": round(float(p50), 4),
                "p95": round(float(p95), 4),
            }
        out["components"] = dist
    lost = [f.failed_at_s for f in frames if not f.survived]
    if lost:
        out["mean_failed_at_s"] = round(float(np.mean(lost)), 2)
    return out


def aggregate_slo(out: Dict[str, np.ndarray]) -> Optional[Dict]:
    """Cross-seed summary of a ``replay_batch`` output's request-level SLO
    arrays (``slo_p50_s`` / ``slo_p99_s`` / ``slo_dropped`` /
    ``slo_availability`` — present only when the scenario declares a
    traffic spec; returns None otherwise). Latency stats are taken over
    the seeds whose campaigns admitted any traffic (finite percentiles);
    drop/availability means cover every seed."""
    if "slo_p99_s" not in out:
        return None
    p50 = np.asarray(out["slo_p50_s"], np.float64)
    p99 = np.asarray(out["slo_p99_s"], np.float64)
    keep = np.isfinite(p99)
    lat = lambda v: (
        {
            "mean": round(float(np.mean(v[keep])), 6),
            "p95_across_seeds": round(float(np.percentile(v[keep], 95)), 6),
        }
        if keep.any()
        else None
    )
    return {
        "n_seeds": int(p99.size),
        "n_with_traffic": int(keep.sum()),
        "p50_s": lat(p50),
        "p99_s": lat(p99),
        "dropped_mean": round(float(np.mean(out["slo_dropped"])), 3),
        "availability_mean": round(float(np.mean(out["slo_availability"])), 6),
        "availability_min": round(float(np.min(out["slo_availability"])), 6),
    }


def availability_timeline(trace, n_hosts: Optional[int] = None) -> List[Tuple[float, float]]:
    """Fraction of hosts up over time, stepped at each failure (down) and
    provision (back up) event of a :class:`~repro_torch.obs.trace.
    CampaignTrace`. Returns ``[(t, frac_up), ...]`` starting at
    ``(0.0, 1.0)``."""
    n = int(n_hosts or trace.n_hosts)
    up = n
    points: List[Tuple[float, float]] = [(0.0, 1.0)]
    for ev in trace.events:
        if ev.kind == "failure":
            up -= 1
        elif ev.kind == "provision":
            up += 1
        else:
            continue
        points.append((ev.t, up / n))
    return points


def verdict_ledger(trace) -> Dict:
    """Per-detector claim accounting from a trace's ``verdict`` events:
    ``true_saves`` (claimed ∧ real lead window → migrated ahead),
    ``false_claims`` (claimed, no signature — pays wasted prediction
    work), ``blind`` (unclaimed failures handled reactively)."""
    claims = saves = blind = 0
    detector = trace.detector
    for ev in trace.events:
        if ev.kind != "verdict":
            continue
        detector = ev.arg("detector", detector)
        if ev.arg("predicted"):
            claims += 1
            if ev.arg("saved"):
                saves += 1
        else:
            blind += 1
    return {
        "detector": detector,
        "n_verdicts": claims + blind,
        "claims": claims,
        "true_saves": saves,
        "false_claims": claims - saves,
        "blind": blind,
    }
