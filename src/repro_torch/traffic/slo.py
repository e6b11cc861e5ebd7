"""Request-level SLO billing: one campaign trial priced in latency terms.

The makespan accounting (engine + replay fold) answers "how much
longer did the job take"; a serving fleet is judged on what its *users*
saw. :func:`bill_slo` folds one trial's failure schedule against a
:class:`~repro_torch.traffic.arrivals.TrafficSpec` and produces p50/p99
request latency, dropped-request count and an availability fraction:

1. a pure-numpy **mini-replay** of the campaign control flow (the exact
   victim-resolution / spare-pool / strike / repair semantics the engine
   and the torch replay fold share) extracts the serving facts — when shards
   were down recovering, when the fleet re-sharded, when spares were
   free, when the campaign stranded;
2. those facts are distilled to a per-accounting-interval
   :class:`ServingTimeline`;
3. the campaign's :class:`~repro_torch.traffic.autoscale.Autoscaler` turns the
   timeline into a capacity plan (requests/s per interval) priced from
   the workload's ``step_time(n_shards)`` surface;
4. a deterministic queue fold meters Poisson arrivals (the pre-sampled
   request tape) against that capacity, shedding requests that would
   wait longer than the spec's admission bound.

**Parity contract.** Everything here is a deterministic pure function of
``(spec, tape arrays, verdict tape, cost tables, seed, autoscaler)`` —
no rng beyond the pre-sampled tapes, no torch. The reference
:class:`~repro_torch.scenarios.engine.CampaignEngine` and the batched
:func:`~repro_torch.scenarios.trajectory.replay_batch` both call this ONE
function with the identical inputs (the engine's unpadded tape; the
batch's valid-prefix slices), so the four SLO numbers are trial-for-
trial bitwise identical between the two paths by construction — the
same shared-function idiom as ``degrade_slowdown_s``.

Per-event serving outages by billing mode: ``window`` strategies pause
the victim shard for ``reinstate_s`` (checkpoint restore) and
additionally stall the whole fleet for ``ckpt_write_s`` at every
checkpoint boundary; ``proactive`` strategies pause a *saved* shard for
the workload's ``migrate_shard_s`` (live migration ahead of the
failure) and an unsaved one for the mechanism's reinstate
(agent vs core via Rules 1-3, the fold's Z-negotiation); ``cold``
restarts pause the shard for ``reinstate_s``. Background probing and
prediction work never block serving — which is exactly why the
latency-billed strategy ordering can differ from the makespan ordering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rules import Z_THRESHOLD
from repro_torch.traffic.arrivals import TrafficSpec, compile_request_tape
from repro_torch.traffic import registry as autoscaler_registry


@dataclass(frozen=True)
class SloBill:
    """One trial's request-level SLO accounting."""

    autoscaler: str
    p50_s: float  # median admitted-request latency (NaN if none admitted)
    p99_s: float  # tail admitted-request latency (NaN if none admitted)
    offered: int  # requests offered over the horizon
    dropped: float  # requests shed (admission bound) or never served
    availability: float  # served / offered (1.0 when nothing was offered)
    n_rebalances: int = 0
    n_scaleouts: int = 0


@dataclass(frozen=True)
class ServingTimeline:
    """Per-accounting-interval serving state distilled from one trial.

    Parallel float64 arrays over the request tape's valid intervals;
    the autoscalers consume this (and nothing else), so a policy can
    never read state the engine/fold parity contract doesn't cover.
    ``outage_shard_ivs`` counts shard-interval-equivalents lost to
    recovery pauses at fixed fleet size (static view), while
    ``live_shard_ivs``/``rebalance_shard_ivs`` describe the elastic
    view (fleet follows the live host count; each churn event pays a
    collective re-shard stall)."""

    n_shards0: int
    requests_per_step: float
    grid: np.ndarray  # float64 [g] shard-count grid of the workload surface
    step_s: np.ndarray  # float64 [g] step_time_s surface on that grid
    start_s: np.ndarray  # float64 [n] interval starts
    width_s: np.ndarray  # float64 [n] interval widths
    counts: np.ndarray  # int64   [n] offered arrivals per interval
    outage_shard_ivs: np.ndarray  # float64 [n] static-view recovery loss
    rebalance_shard_ivs: np.ndarray  # float64 [n] elastic-view re-shard loss
    degrade_shard_ivs: np.ndarray  # float64 [n] degrade-window capacity loss
    live_shard_ivs: np.ndarray  # float64 [n] mean live shards (elastic view)
    alive_frac: np.ndarray  # float64 [n] fraction before campaign death
    pool_free: np.ndarray  # int64   [n] free spares at interval start
    n_shrink_events: int

    def step_s_at(self, n_shards) -> np.ndarray:
        """``step_time_s`` linearly interpolated at ``n_shards`` (numpy —
        float64 on both billing paths, on the host, with no tensor in
        between)."""
        return np.interp(np.asarray(n_shards, np.float64), self.grid, self.step_s)

    def per_shard_rps(self, n_shards) -> np.ndarray:
        """Requests/s one shard retires when the fleet runs ``n_shards``."""
        return self.requests_per_step / self.step_s_at(n_shards)


# ------------------------------------------------------------------ control


def _control_flow(
    spec,
    *,
    times: np.ndarray,
    victim: np.ndarray,
    parent: np.ndarray,
    predictable: np.ndarray,
    verdicts: np.ndarray,
    draws: np.ndarray,
    mode: str,
    mechanism: str,
    coeffs: np.ndarray,
    migrate_s: float,
    rules_agent_small: bool,
    continue_after_strand: bool,
) -> Dict:
    """Scalar-numpy port of the shared campaign control flow.

    Replays one trial's schedule with the engine/fold victim-
    resolution, spare-pool FIFO, strike/blacklist and repair semantics,
    and records the *serving* facts: per-event recovery outages
    ``(t, seconds)``, shard churn windows ``(t_fail, t_rejoin)``,
    spare-pool deltas ``(t, +/-1)`` and the strand time. With
    ``continue_after_strand`` (elastic policies) a stranded slot retires
    its shard permanently and the replay keeps going where the makespan
    accounting would declare the campaign dead."""
    n_workers = int(spec.n_nodes)
    n_spares = int(spec.n_spares)
    H = n_workers + n_spares
    n_slots = len(times)
    c_reinstate = float(coeffs[2])
    c_agent_rst = float(coeffs[4])
    c_core_rst = float(coeffs[6])

    down = np.zeros(H, bool)
    repair_at = np.full(H, np.inf, np.float64)
    black = np.zeros(H, bool)
    strikes = np.zeros(H, np.int64)
    occupied = np.zeros(H, bool)
    occupied[:n_workers] = True
    spare_seq = np.full(H, np.inf, np.float64)
    spare_seq[n_workers:] = np.arange(n_spares, dtype=np.float64)
    next_seq = float(n_spares)
    deg = np.zeros(H, np.int64)
    if n_workers > 1:
        deg[: n_workers - 1] = 1
        deg[n_workers - 1] = n_workers - 1
    rcount = 0
    fired = np.zeros(n_slots, bool)
    tgt_rec = np.full(n_slots, -1, np.int64)
    alive = True
    failed_at_s = np.inf
    repair_none = spec.repair_s is None
    idx = np.arange(H)

    outages: List[Tuple[float, float]] = []  # (t, seconds) one shard pauses
    churn: List[Tuple[float, float]] = []  # (t_fail, t_rejoin) shard windows
    pool_ev: List[Tuple[float, int]] = []  # (t, delta) free-spare changes

    for j in range(n_slots):
        t = float(times[j])
        if not t < spec.horizon_s:
            continue
        if not alive and not continue_after_strand:
            break

        # repairs completing strictly before t rejoin the pool in
        # (completion time, host) order — the engine's heap order
        due = idx[repair_at < t]
        if due.size:
            order = due[np.lexsort((due, repair_at[due]))]
            spare_seq[order] = next_seq + np.arange(due.size, dtype=np.float64)
            next_seq += float(due.size)
            down[order] = False
            repair_at[order] = np.inf

        par = int(parent[j])
        if par >= 0:
            if not fired[par]:
                continue  # parent never migrated: cascade child unborn
            v = int(tgt_rec[par])
        else:
            v = int(victim[j])
        if v < 0 or down[v]:
            continue  # already down — coalesced with an earlier event

        strikes[v] += 1
        permanent = repair_none or strikes[v] >= spec.max_strikes
        has_work = bool(occupied[v])

        target = -1
        if has_work:
            okf = ~black & ~down & ~occupied
            pool = np.isfinite(spare_seq) & okf
            if pool.any():
                target = int(np.argmin(np.where(pool, spare_seq, np.inf)))
            elif okf[(v - 1) % H]:
                target = (v - 1) % H
            elif okf[(v + 1) % H]:
                target = (v + 1) % H
            else:
                m3 = okf.copy()
                m3[v] = False
                target = int(np.argmax(m3)) if m3.any() else -1
        stranded = has_work and target < 0
        handled = has_work and target >= 0

        if handled:
            if mode == "window" or mode == "cold":
                pause_s = c_reinstate
            else:  # proactive: saved shards live-migrate, unsaved reinstate
                if mechanism == "agent":
                    is_agent = True
                elif mechanism == "core":
                    is_agent = False
                else:  # "rules": Z-negotiation per event (Rules 1-3)
                    is_agent = rules_agent_small and deg[v] > Z_THRESHOLD
                if bool(verdicts[j]) and bool(predictable[j]):
                    pause_s = migrate_s
                else:
                    pause_s = c_agent_rst if is_agent else c_core_rst
            outages.append((t, float(pause_s)))
            if np.isfinite(spare_seq[target]):
                pool_ev.append((t, -1))
            occupied[v] = False
            occupied[target] = True
            spare_seq[target] = np.inf
            deg[target] = deg[v]
            deg[v] = 0
            fired[j] = True
            tgt_rec[j] = target

        if np.isfinite(spare_seq[v]):
            pool_ev.append((t, -1))
        down[v] = True
        spare_seq[v] = np.inf
        rejoin_s = np.inf
        if stranded:
            if alive:
                alive = False
                failed_at_s = t
        elif permanent:
            black[v] = True
        else:
            rdraw = float(draws[min(rcount, len(draws) - 1)])
            repair_at[v] = t + rdraw
            rcount += 1
            rejoin_s = t + rdraw
            pool_ev.append((rejoin_s, 1))
        if has_work:
            churn.append((t, rejoin_s))

    return {
        "outages": outages,
        "churn": churn,
        "pool_ev": pool_ev,
        "alive": alive,
        "failed_at_s": failed_at_s,
    }


# ----------------------------------------------------------------- timeline


def _overlap_s(start_s, width_s, t0: float, t1: float) -> np.ndarray:
    """Per-interval overlap seconds with the window ``[t0, t1)``."""
    return np.clip(
        np.minimum(start_s + width_s, t1) - np.maximum(start_s, t0), 0.0, None
    )


def _degrade_shard_ivs(spec, start_s, width_s) -> np.ndarray:
    """Capacity a degrading-but-alive node sheds, in shard-interval
    equivalents: the exact integral of ``1 - speed(t)`` (linear ramp to
    ``factor``) over each accounting interval."""
    out = np.zeros_like(start_s)
    end_s = start_s + width_s
    for t0, t1, _node, factor, ramp_s in spec.degrade_timeline():
        depth = 1.0 - factor
        if depth <= 0.0:
            continue
        # ramp part: (t - t0)/ramp_s on [t0, t0 + ramp_s) ∩ window
        r1 = min(t0 + ramp_s, t1)
        if ramp_s > 0.0 and r1 > t0:
            a = np.clip(start_s, t0, r1)
            b = np.clip(end_s, t0, r1)
            out += depth * np.clip(b - a, 0.0, None) * ((a + b) / 2.0 - t0) / ramp_s
        # flat part: full depth on [t0 + ramp_s, t1) ∩ window
        out += depth * _overlap_s(start_s, width_s, max(t0 + ramp_s, t0), t1)
    return out / np.maximum(width_s, 1e-12)


def _serving_timeline(
    spec, rtape, flow: Dict, wtable, traffic: TrafficSpec, mode: str
) -> ServingTimeline:
    m = rtape.valid
    start_s = rtape.start_s[m]
    width_s = rtape.width_s[m]
    counts = rtape.counts[m]
    safe_w = np.maximum(width_s, 1e-12)
    n0 = int(spec.n_nodes)
    grid = np.asarray(wtable.n_shards, np.float64)
    step_s = np.asarray(wtable.step_time_s, np.float64)
    ckpt_write_s = float(np.interp(n0, grid, np.asarray(wtable.ckpt_write_s, np.float64)))
    reb_s = float(np.interp(n0, grid, np.asarray(wtable.rebalance_shard_s, np.float64)))

    # static view: each recovery pauses one shard; window strategies also
    # stall the whole fleet while each periodic checkpoint writes
    outage = np.zeros_like(start_s)
    for t, pause_s in flow["outages"]:
        outage += _overlap_s(start_s, width_s, t, t + pause_s) / safe_w
    if mode == "window":
        k = 1
        while k * spec.period_s < spec.horizon_s:
            t = k * spec.period_s
            outage += n0 * _overlap_s(start_s, width_s, t, t + ckpt_write_s) / safe_w
            k += 1

    # elastic view: the fleet follows the live host count; every churn
    # event (a shard-carrying host going down) costs a collective
    # re-shard stall of the workload's rebalance surface
    live = np.full_like(start_s, float(n0))
    reb = np.zeros_like(start_s)
    for t_fail, t_rejoin in flow["churn"]:
        live -= _overlap_s(start_s, width_s, t_fail, t_rejoin) / safe_w
        reb += n0 * _overlap_s(start_s, width_s, t_fail, t_fail + reb_s) / safe_w

    if np.isfinite(flow["failed_at_s"]) and not flow["alive"]:
        alive_frac = np.clip((flow["failed_at_s"] - start_s) / safe_w, 0.0, 1.0)
    else:
        alive_frac = np.ones_like(start_s)

    pool_free = np.full(start_s.shape, spec.n_spares, np.int64)
    for t, delta in flow["pool_ev"]:
        pool_free += np.where(start_s >= t, delta, 0)
    pool_free = np.maximum(pool_free, 0)

    return ServingTimeline(
        n_shards0=n0,
        requests_per_step=float(traffic.requests_per_step),
        grid=grid,
        step_s=step_s,
        start_s=start_s,
        width_s=width_s,
        counts=counts.astype(np.int64),
        outage_shard_ivs=outage,
        rebalance_shard_ivs=reb,
        degrade_shard_ivs=_degrade_shard_ivs(spec, start_s, width_s),
        live_shard_ivs=np.clip(live, 0.0, None),
        alive_frac=alive_frac,
        pool_free=pool_free,
        n_shrink_events=len(flow["churn"]),
    )


# --------------------------------------------------------------- queue fold


def _fold_queue(
    counts: np.ndarray,
    width_s: np.ndarray,
    capacity_rps: np.ndarray,
    service_s: np.ndarray,
    queue_wait_cap_s: float,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Deterministic fluid-queue fold on the accounting grid.

    Returns per-interval mean admitted-request wait (backlog drain at
    the interval's capacity + one service step), the admitted weights,
    and the total dropped count (admission-bound shed + backlog never
    served by the horizon). Requests that would wait longer than
    ``queue_wait_cap_s`` are dropped, attributed to the interval whose
    arrivals pushed the backlog over."""
    n = len(counts)
    waits = np.zeros(n, np.float64)
    admitted = np.zeros(n, np.float64)
    backlog = 0.0
    dropped = 0.0
    for i in range(n):
        a = float(counts[i])
        cap_rps = float(capacity_rps[i])
        cap_req = cap_rps * float(width_s[i])
        if cap_rps > 1e-12:
            waits[i] = (backlog + 0.5 * a) / cap_rps + float(service_s[i])
        else:
            waits[i] = np.inf
        served = min(backlog + a, cap_req)
        backlog = backlog + a - served
        shed = max(0.0, backlog - queue_wait_cap_s * cap_rps)
        backlog -= shed
        dropped += shed
        admitted[i] = max(a - shed, 0.0)
    dropped += backlog  # never served inside the horizon
    return waits, admitted, dropped


def _weighted_percentile(values: np.ndarray, weights: np.ndarray, q: float) -> float:
    """Weighted lower-quantile over finite-valued entries (NaN if no
    weight survives) — deterministic, no interpolation ambiguity."""
    keep = np.isfinite(values) & (weights > 0)
    if not keep.any():
        return float("nan")
    v = values[keep]
    w = weights[keep]
    order = np.argsort(v, kind="stable")
    v = v[order]
    cw = np.cumsum(w[order])
    i = int(np.searchsorted(cw, q * cw[-1], side="left"))
    return float(v[min(i, len(v) - 1)])


# --------------------------------------------------------------------- bill


def bill_slo(
    spec,
    *,
    times: np.ndarray,
    victim: np.ndarray,
    parent: np.ndarray,
    predictable: np.ndarray,
    verdicts: np.ndarray,
    draws: np.ndarray,
    table,
    wtable,
    seed: int,
    autoscaler=None,
    rules_agent_small: bool = True,
) -> SloBill:
    """Price one campaign trial in request-latency terms.

    ``table`` is the strategy's :class:`~repro_torch.strategies.base.
    StrategyCostTable` (mode / mechanism / coefficient seconds),
    ``wtable`` the workload's :class:`~repro_torch.workloads.base.
    WorkloadCostTable` (step-time / transfer surfaces at the fleet's
    shard grid), and the array arguments are one trial's schedule-order
    tape — the engine passes its unpadded compiled tape, the batched
    replay path its valid-prefix slices, so both bill bitwise
    identically. ``autoscaler`` is a registry name, an
    :class:`~repro_torch.traffic.autoscale.Autoscaler` instance, or None for
    the traffic spec's default."""
    traffic: Optional[TrafficSpec] = spec.traffic
    if traffic is None:
        raise ValueError(f"scenario {spec.name!r} declares no traffic spec")
    if spec.partition_timeline():
        raise ValueError(
            "serving SLO billing does not support partition scenarios yet"
        )
    from repro_torch.traffic.autoscale import Autoscaler

    if autoscaler is None:
        autoscaler = traffic.autoscaler
    policy = (
        autoscaler
        if isinstance(autoscaler, Autoscaler)
        else autoscaler_registry.get(autoscaler)
    )

    n0 = int(spec.n_nodes)
    grid = np.asarray(wtable.n_shards, np.float64)
    migrate_s = float(
        np.interp(n0, grid, np.asarray(wtable.migrate_shard_s, np.float64))
    )
    flow = _control_flow(
        spec,
        times=np.asarray(times, np.float64),
        victim=np.asarray(victim, np.int64),
        parent=np.asarray(parent, np.int64),
        predictable=np.asarray(predictable, bool),
        verdicts=np.asarray(verdicts, bool),
        draws=np.asarray(draws, np.float64),
        mode=table.mode,
        mechanism=table.mechanism,
        coeffs=np.asarray(
            [
                table.probe_s_per_hour,
                table.predict_s,
                table.reinstate_s,
                table.overhead_s,
                table.agent_reinstate_s,
                table.agent_overhead_s,
                table.core_reinstate_s,
                table.core_overhead_s,
            ],
            np.float64,
        ),
        migrate_s=migrate_s,
        rules_agent_small=bool(rules_agent_small),
        continue_after_strand=bool(policy.continue_after_strand),
    )

    rtape = compile_request_tape(traffic, spec.horizon_s, seed)
    tl = _serving_timeline(spec, rtape, flow, wtable, traffic, table.mode)
    plan = policy.plan(tl)
    service_s = plan.service_s
    if service_s is None:
        service_s = np.full_like(tl.start_s, float(tl.step_s_at(n0)))

    waits, admitted, dropped = _fold_queue(
        tl.counts, tl.width_s, plan.capacity_rps, service_s, traffic.queue_wait_cap_s
    )
    offered = int(tl.counts.sum())
    availability = 1.0 if offered == 0 else (offered - dropped) / offered
    return SloBill(
        autoscaler=policy.name,
        p50_s=_weighted_percentile(waits, admitted, 0.50),
        p99_s=_weighted_percentile(waits, admitted, 0.99),
        offered=offered,
        dropped=float(dropped),
        availability=float(availability),
        n_rebalances=int(plan.n_rebalances),
        n_scaleouts=int(plan.n_scaleouts),
    )
