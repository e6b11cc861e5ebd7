"""Discrete-event / closed-form simulator reproducing the paper's Tables 1-2.

Accounting model (reverse-engineered and verified against the published
tables — e.g. Table 1 centralised single server, 1 random failure:
60:00 + 31:14 + 14:08 + 8:05 = 1:53:27 exactly; Table 2 central single 1 h,
5 periodic: 5:00 + 5x(14:00 + 14:08 + 8:05) = 8:01:05 exactly):

    total = J + sum_over_failures(elapsed_since_last_checkpoint
                                  + reinstate + overhead_per_failure)
            [+ probe_cost_per_hour * J  for the proactive approaches]

Micro-costs come from two tiers (kept separate in the output):
  * measured — the agent/core reinstate costs are obtained by actually
    executing the runtime's migration machinery (real state move, real
    dependency surgery, hash-verified) plus profile-modelled control costs;
  * modelled — checkpoint create/restore times from the calibrated
    profile (cluster.py) and staging/log-mining constants in
    ``repro_torch.strategies.costmodel``.

Which strategies exist — and how each one prices a failure — is no longer
encoded here: ``strategy_rows`` iterates the ``repro_torch.strategies`` registry
and reads each strategy's :class:`~repro_torch.strategies.base.StrategyCosts`.
Registering a new strategy makes it appear in the tables automatically.

Cold-restart note: the paper's cold-restart schedule semantics are
underspecified (21:15:17 cannot be reproduced from any restart model we
tried); we use first-crossing progress-mark semantics and report the
difference in EXPERIMENTS.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.agent import Agent
from repro_torch.core.checkpoint import (
    CHECKPOINT_KINDS,
    CheckpointPolicyCfg,
    modelled_checkpoint_overhead_s,
    modelled_restore_s,
)
from repro_torch.core.cluster import get_profile
from repro_torch.core.failure import PREDICTION_LEAD_S, mean_random_failure_time
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.virtual_core import VirtualCore
from repro_torch.strategies.base import CostContext, StrategyRow
from repro_torch.strategies.registry import (
    get as get_strategy,
    get_class as get_strategy_class,
    names as strategy_names,
)

# cost-model constants live with the strategies now; re-exported here for
# backwards compatibility (tests, notebooks):
from repro_torch.strategies.costmodel import (  # noqa: F401  (re-exports)
    COLD_REINSTATE_S,
    LOG_MINING_S,
    OVH_GROWTH,
    PROBE_S_PER_HOUR,
    RANDOM_ELAPSED_S,
    RST_GROWTH,
)

__all__ = [
    "COLD_REINSTATE_S",
    "LOG_MINING_S",
    "MicroCosts",
    "OVH_GROWTH",
    "PROBE_S_PER_HOUR",
    "RANDOM_ELAPSED_S",
    "RST_GROWTH",
    "StrategyRow",
    "fmt_hms",
    "measure_micro",
    "scenario_totals",
    "strategy_rows",
]


@dataclass
class MicroCosts:
    predict_s: float
    agent_reinstate_s: float
    core_reinstate_s: float
    agent_overhead_s: float
    core_overhead_s: float
    ckpt_overhead_s: Dict[str, float]
    ckpt_reinstate_s: Dict[str, float]
    measured_agent_s: float
    measured_core_s: float


def measure_micro(
    profile_name: str = "placentia",
    n_nodes: int = 4,
    z: int = 4,
    s_d_bytes: int = (2 ** 19) * 1024,
    s_p_bytes: Optional[int] = None,
    payload_elems: int = 1 << 16,
) -> MicroCosts:
    """Execute the real migration machinery once per mechanism to obtain the
    measured tier; fill in modelled control/staging parts from the profile.

    Memoized on the full argument tuple: the measurement drives real
    state moves and dependency surgery, and ~10 engine/bench/test call
    sites price campaigns from it. One execution per distinct
    configuration keeps repeated callers on the *identical* ``MicroCosts``
    object — byte-identical totals and one shared jitted replay program —
    instead of a numerically distinct wall-clock remeasurement per call.
    Treat the returned record as read-only."""
    # normalise the "payload defaults to the data size" shorthand BEFORE
    # the cache key so explicit and defaulted spellings share one entry
    return _measure_micro_cached(
        profile_name, n_nodes, z, s_d_bytes, s_p_bytes or s_d_bytes, payload_elems
    )


@lru_cache(maxsize=None)
def _measure_micro_cached(
    profile_name: str,
    n_nodes: int,
    z: int,
    s_d_bytes: int,
    s_p_bytes: int,
    payload_elems: int,
) -> MicroCosts:
    profile = get_profile(profile_name)

    def mk_rt():
        rt = ClusterRuntime(
            n_hosts=n_nodes, n_spares=2, profile=profile, graph=DependencyGraph.star(n_nodes - 1)
        )
        # ensure requested dependency count on node 0
        rt.graph.in_edges.setdefault(0, [])
        while rt.graph.degree(0) < z:
            peer = (rt.graph.degree(0) % (n_nodes - 1)) + 1
            rt.graph.in_edges[0].append(peer)
            rt.graph.out_edges.setdefault(peer, []).append(0)
        return rt

    payload = {"partial": np.zeros(payload_elems, np.float32), "cursor": 123}

    rt = mk_rt()
    rt.occupy(0, payload, "agent:0")
    ag = Agent(0, 0, payload)
    arep = ag.migrate(rt)
    assert arep["hash_ok"]

    rt = mk_rt()
    rt.occupy(0, payload, "core:0")
    vc = VirtualCore(0, 0)
    crep = vc.migrate_job(rt)
    assert crep["hash_ok"]

    # reinstate: control plane only — but scale the modelled metadata term to
    # the *experiment's* S_d/S_p (the in-process payload is a small stand-in)
    from repro_torch.core.migration import META_LOG_COEF

    speed = max(profile.node_speed, 0.1)
    meta_measured = META_LOG_COEF * np.log2(max(arep["bytes"], 2)) / speed
    meta_target = META_LOG_COEF * np.log2(max(s_p_bytes, 2)) / speed
    agent_reinstate = arep["reinstate_s"] - meta_measured + meta_target
    core_reinstate = crep["reinstate_s"] - meta_measured + meta_target

    staging = s_d_bytes / profile.node_bw
    agent_overhead = LOG_MINING_S["agent"] / speed + staging + profile.proc_spawn_s
    core_overhead = LOG_MINING_S["core"] / speed + staging + profile.proc_spawn_s

    total_bytes = s_d_bytes * max(n_nodes - 1, 1)
    co, cr = {}, {}
    for kind in CHECKPOINT_KINDS:  # infra variants, not strategy dispatch
        cfgk = CheckpointPolicyCfg(kind=kind, n_servers=3)
        co[kind] = modelled_checkpoint_overhead_s(cfgk, profile, total_bytes, n_nodes)
        cr[kind] = modelled_restore_s(cfgk, profile, total_bytes, n_nodes)

    return MicroCosts(
        predict_s=PREDICTION_LEAD_S,
        agent_reinstate_s=float(agent_reinstate),
        core_reinstate_s=float(core_reinstate),
        agent_overhead_s=float(agent_overhead),
        core_overhead_s=float(core_overhead),
        ckpt_overhead_s=co,
        ckpt_reinstate_s=cr,
        measured_agent_s=float(arep["reinstate_measured_s"]),
        measured_core_s=float(crep["reinstate_measured_s"]),
    )


# tests that want a fresh wall-clock measurement can drop the memo table
measure_micro.cache_clear = _measure_micro_cached.cache_clear  # type: ignore[attr-defined]
measure_micro.cache_info = _measure_micro_cached.cache_info  # type: ignore[attr-defined]


def _totals(
    J_s: float,
    period_s: float,
    elapsed_periodic_s: float,
    elapsed_random_s: float,
    reinstate_s: float,
    overhead_s: float,
    probe_per_hour_s: float,
    lost_progress: bool = True,
):
    """Failure counts decoded from the published tables: periodic failures
    fire once per (possibly partial) window -> round(J/p); random failures
    only in complete windows -> floor(J/p)."""
    hours = J_s / 3600.0
    p_h = period_s / 3600.0
    n_periodic = max(1, int(round(hours / p_h)))
    n_random = max(1, int(np.floor(hours / p_h)))
    base = J_s + probe_per_hour_s * hours

    def tot(elapsed, n):
        lost = elapsed if lost_progress else 0.0
        return base + n * (lost + reinstate_s + overhead_s)

    return (
        tot(elapsed_periodic_s, n_periodic),
        tot(elapsed_random_s, n_random),
        tot(elapsed_random_s, 5 * n_random),
    )


def strategy_rows(
    job_hours: float,
    periodicities_h: List[float],
    profile_name: str = "placentia",
    n_nodes: int = 4,
    z: int = 4,
    s_d_bytes: int = (2 ** 19) * 1024,
    micro: Optional[MicroCosts] = None,
    periodic_offset_min: Optional[float] = None,  # Table 1 uses 15; Table 2 14*p
) -> List[StrategyRow]:
    """Rows for Tables 1-2, one per registered strategy per periodicity.

    Each strategy prices itself via ``costs() -> StrategyCosts``: for the
    reactive policies a failure loses the elapsed time since the last
    checkpoint (``lost_progress``); for the proactive approaches
    prediction + migration preserve progress. Strategies outside the
    per-periodicity grid (cold restart) contribute their own rows via
    ``table_rows``."""
    micro = micro or measure_micro(profile_name, n_nodes, z, s_d_bytes)
    J = job_hours * 3600.0
    rows: List[StrategyRow] = []

    strats = [get_strategy(name) for name in strategy_names()]
    for strat in strats:
        if not strat.tabulated:
            rows.extend(strat.table_rows(job_hours) or [])

    for p_h in periodicities_h:
        period_s = p_h * 3600.0
        elapsed_periodic = (
            periodic_offset_min * 60.0
            if periodic_offset_min is not None
            else 14 * 60.0 * p_h  # Table 2 scales the offset with the period
        )
        elapsed_random = RANDOM_ELAPSED_S.get(p_h, mean_random_failure_time(period_s))
        ctx = CostContext(micro=micro, period_h=p_h, z=z, s_d_bytes=s_d_bytes)
        for strat in strats:
            if not strat.tabulated:
                continue
            c = strat.costs(ctx)
            t1p, t1r, t5r = _totals(
                J,
                period_s,
                elapsed_periodic,
                elapsed_random,
                c.reinstate_s + c.predict_s,
                c.overhead_s,
                c.probe_s_per_hour,
                lost_progress=c.lost_progress,
            )
            rows.append(
                StrategyRow(
                    strat.name, p_h, c.predict_s, c.reinstate_s, c.reinstate_s,
                    c.overhead_s, c.overhead_s, J, t1p, t1r, t5r,
                )
            )
    return rows


def fmt_hms(s: float) -> str:
    s = int(round(s))
    return f"{s//3600:02d}:{(s%3600)//60:02d}:{s%60:02d}"


# ------------------------------------------------------------------------
# Scenario-engine integration: a scenario that reduces to the paper's
# Tables 1-2 patterns is priced with the EXACT same `strategy_rows`
# arithmetic as the seed simulator — bit-for-bit identical totals; every
# other scenario runs through the event-driven CampaignEngine.
# ------------------------------------------------------------------------
def scenario_totals(
    scenario,
    strategies=None,
    micro: Optional[MicroCosts] = None,
    profile_name: str = "placentia",
    workload=None,
    device="cuda",
) -> Dict[str, Dict]:
    """Total execution time of a scenario under each FT strategy.

    `scenario` is a ScenarioSpec or a registered scenario name;
    `strategies` defaults to every name in the strategy registry. Returns
    {strategy: {"total_s", "source", "survived", ...}} where source is
    "closed_form" for the paper-reducible specs and "engine" otherwise.

    ``workload`` (a registered name or :class:`~repro_torch.workloads.base.
    Workload` instance; default: the spec's declared workload, then
    ``"analytic"``) supplies the micro-costs when none are given — the
    ``analytic`` workload reduces to the seed ``measure_micro`` call
    bit-for-bit, calibrated workloads price the same campaign from their
    own cost surfaces. ``device`` is where a workload or detector resolved
    from a name computes (the card unless the caller asks for the CPU)."""
    from repro_torch.scenarios import registry  # lazy: avoid import cycle
    from repro_torch.scenarios.engine import CampaignEngine
    from repro_torch.workloads import resolve as resolve_workload

    spec = registry.get(scenario) if isinstance(scenario, str) else scenario
    strategies = (
        tuple(strategy_names())
        if strategies is None
        else tuple(get_strategy_class(s).name for s in strategies)  # aliases ok
    )
    workload = resolve_workload(workload, spec, device=device)
    micro = micro or workload.micro(profile_name, n_nodes=spec.n_nodes)
    out: Dict[str, Dict] = {}

    proc = next(
        (p for p in spec.processes if p.kind in ("periodic", "random")), None
    )
    per_window = int(proc.params.get("per_window", 1)) if proc else 1
    # the published tables only price 1 failure/window (both kinds) and 5
    # random failures/window; anything else has no exact closed form ->
    # execute through the engine
    closed_form_ok = (
        spec.closed_form in ("periodic", "random")
        and len(spec.processes) == 1  # extra processes have no table column
        and proc is not None
        and proc.kind == spec.closed_form  # flag must describe the process
        and "period_s" not in proc.params  # per-process period override:
        #   honoured by events() but invisible to strategy_rows
        and (per_window == 1 or (per_window == 5 and spec.closed_form == "random"))
    )

    if closed_form_ok:
        offset_min = (
            proc.params.get("offset_s", 900.0) / 60.0
            if spec.closed_form == "periodic"
            else None
        )
        rows = strategy_rows(
            spec.horizon_s / 3600.0,
            [spec.period_s / 3600.0],
            profile_name=profile_name,
            n_nodes=spec.n_nodes,
            micro=micro,
            periodic_offset_min=offset_min,
        )
        for r in rows:
            if r.strategy not in strategies:
                continue
            if spec.closed_form == "periodic":
                total = r.exec_1periodic_s
            elif per_window == 5:
                total = r.exec_5random_s
            else:
                total = r.exec_1random_s
            out[r.strategy] = {
                "total_s": float(total),
                "source": "closed_form",
                "survived": True,
            }
        return out

    for strat in strategies:
        res = CampaignEngine(
            spec, approach=strat, profile=profile_name, micro=micro, workload=workload,
            device=device,
        ).run()
        out[strat] = {
            "total_s": res.total_s,
            "source": "engine",
            "survived": res.survived,
            "failed_at_s": res.failed_at_s,
            "n_events": res.n_events,
            "n_migrations": res.n_migrations,
        }
    return out
