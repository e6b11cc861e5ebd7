"""Vectorised Monte-Carlo: closed-form totals AND full engine trajectories.

The paper reports 5000-trial means but the seed simulator runs one trial
per Python call. Two batched paths live here, both on the card unless the
caller asks for the CPU:

``mc_totals``
    the closed-form total of ``core/sim.py`` —

        total = J + probe·hours + Σ_failures (lost + reinstate + overhead)

    with the random failure instant uniform within each inter-checkpoint
    window — evaluated for thousands of seeds at once from float64
    uniforms drawn by a ``torch.Generator`` on the device, seeded from
    ``seed``. The reference draws with jax's threefry at float32, whose
    bits no torch generator reproduces: the two agree statistically, not
    bit for bit. Only the paper's window patterns reduce to this form;
    periodic scenarios are deterministic, so their "Monte-Carlo" collapses
    to a single evaluation (numpy, equal to the reference's).
    ``python_loop_baseline`` is the faithful one-trial-per-call
    formulation used as that path's speedup yardstick.

``mc_trajectories``
    Monte-Carlo over full *engine trajectories*: every scenario family —
    cascade, rack, flaky, burst, partition, arbitrary compositions — is
    compiled to padded/masked event tapes
    (:func:`repro_torch.scenarios.trajectory.compile_batch`) and replayed
    for all seeds in one float64 fold
    (:func:`repro_torch.scenarios.trajectory.replay_batch`), reproducing
    the Python :class:`CampaignEngine` trial-for-trial — including
    survival / spare-exhaustion, blacklisting and heavy-tailed repairs —
    and reporting the recovery-cost *tails* (p5/p50/p95), which is what
    actually separates reactive from proactive schemes (Treaster,
    cs/0501002). The ``detector`` argument swaps the oracle
    ``predictable`` bits for a registered detector's pre-sampled verdict
    tape (e.g. ``"ml"``), so detection quality is Monte-Carlo-able too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MCParams:
    """Closed-form campaign parameters (one strategy, one scenario)."""

    J_s: float  # job length == horizon
    period_s: float  # checkpoint interval == failure-window length
    per_window: int  # failures per window
    reinstate_s: float
    overhead_s: float
    probe_per_hour_s: float = 0.0
    lost_progress: bool = True  # False for the proactive approaches
    lead_s: float = 0.0  # prediction lead added per failure when proactive
    fixed_lost_s: Optional[float] = None  # periodic scenarios: deterministic
    #   loss per failure (the checkpoint offset) instead of uniform sampling


def _n_windows(J_s: float, period_s: float, periodic: bool = False) -> int:
    """Failure-window count, decoded from the published tables exactly as
    sim._totals does: periodic failures fire once per possibly-partial
    window (round), random failures only in complete windows (floor)."""
    op = np.round if periodic else np.floor
    return max(1, int(op(J_s / period_s)))


def _mc_totals_draw(
    n_seeds: int,
    J_s: float,
    period_s: float,
    per_window: int,
    n_windows: int,
    reinstate_s: float,
    overhead_s: float,
    probe_s: float,
    lead_s: float,
    seed: int,
    dev: torch.device,
) -> torch.Tensor:
    """Per-seed totals [n_seeds], float64, on ``dev``: failure instants
    uniform within each window, ``per_window`` per window, summed in the
    reference's order ``J + probe + lost + n_fail * (...)``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    f64 = torch.float64
    u = torch.rand((n_seeds, n_windows * per_window), generator=gen, dtype=f64, device=dev)
    u = u * torch.tensor(period_s, dtype=f64, device=dev)
    lost = u.sum(dim=1)
    n_fail = n_windows * per_window
    per_fail = torch.tensor(reinstate_s + overhead_s + lead_s, dtype=f64, device=dev)
    return J_s + probe_s + lost + n_fail * per_fail


def mc_totals(params: MCParams, n_seeds: int = 1000, seed: int = 0, device="cuda") -> Dict:
    """Vectorised totals over `n_seeds` independent trials.

    Returns summary stats plus the raw per-seed totals (numpy). Scenarios
    with no stochastic term (periodic `fixed_lost_s`, or proactive with no
    lost progress) collapse to a single deterministic evaluation, on the
    host; the others draw on ``device`` (the card unless the caller asks
    for the CPU)."""
    nw = _n_windows(params.J_s, params.period_s, periodic=params.fixed_lost_s is not None)
    if params.fixed_lost_s is not None or not params.lost_progress:
        n_fail = nw * params.per_window
        lost = params.fixed_lost_s if params.lost_progress else 0.0
        total = (
            params.J_s
            + params.probe_per_hour_s * params.J_s / 3600.0
            + n_fail * (lost + params.reinstate_s + params.overhead_s + params.lead_s)
        )
        totals = np.full(n_seeds, total, np.float64)
        return {
            "n_seeds": int(n_seeds),
            "mean_s": float(total),
            "std_s": 0.0,
            "p5_s": float(total),
            "p50_s": float(total),
            "p95_s": float(total),
            "totals": totals,
        }
    dev = resolve_device(device)
    totals = _mc_totals_draw(
        int(n_seeds),
        float(params.J_s),
        float(params.period_s),
        int(params.per_window),
        nw,
        float(params.reinstate_s),
        float(params.overhead_s),
        float(params.probe_per_hour_s) * params.J_s / 3600.0,
        float(params.lead_s),
        seed,
        dev,
    ).cpu().numpy()
    return {
        "n_seeds": int(n_seeds),
        "mean_s": float(totals.mean()),
        "std_s": float(totals.std()),
        "p5_s": float(np.percentile(totals, 5)),
        "p50_s": float(np.percentile(totals, 50)),
        "p95_s": float(np.percentile(totals, 95)),
        "totals": totals,
    }


def python_loop_baseline(params: MCParams, n_seeds: int = 1000, seed: int = 0) -> np.ndarray:
    """The seed simulator's style: one trial per Python call, scalar math.

    Kept deliberately faithful to `sim.py`'s per-trial structure (fresh rng
    per trial, Python loop over windows/failures) as the speedup yardstick."""
    nw = _n_windows(params.J_s, params.period_s, periodic=params.fixed_lost_s is not None)
    probe = params.probe_per_hour_s * params.J_s / 3600.0
    out = np.empty(n_seeds, np.float64)
    for i in range(n_seeds):
        rng = np.random.default_rng((seed, i))
        total = params.J_s + probe
        for _w in range(nw):
            for _k in range(params.per_window):
                if not params.lost_progress:
                    lost = 0.0
                elif params.fixed_lost_s is not None:
                    lost = params.fixed_lost_s
                else:
                    lost = rng.uniform(0.0, params.period_s)
                total += lost + params.reinstate_s + params.overhead_s + params.lead_s
        out[i] = total
    return out


def params_from_scenario(
    spec, strategy: str, micro, periodicity_growth: bool = True
) -> MCParams:
    """Reduce a closed-form-able ScenarioSpec + strategy to MCParams.

    The per-failure costs come straight from the registered strategy's
    ``costs() -> StrategyCosts`` — the same record ``sim.strategy_rows``
    tabulates (growth factors with the checkpoint period, probe costs,
    lead time). Periodic scenarios match the table rows exactly
    (deterministic `fixed_lost_s`); random scenarios land ~1 % BELOW them
    systematically, because MC samples the true uniform loss (mean
    period/2) while the tables bake in the paper's measured elapsed means
    (`RANDOM_ELAPSED_S`, slightly above uniform).

    ``periodicity_growth=False`` prices reactive strategies at the 1 h
    (growth = 1) point regardless of the spec's period."""
    from repro_torch.strategies import CostContext, get as get_strategy

    p_h = spec.period_s / 3600.0
    per_window = 1
    fixed_lost_s = None
    for proc in spec.processes:
        if proc.kind in ("periodic", "random"):
            # FIRST matching process, same as sim.scenario_totals' pricing
            per_window = proc.params.get("per_window", 1)
            if proc.kind == "periodic":
                # deterministic loss: the fixed offset after each checkpoint
                fixed_lost_s = float(proc.params.get("offset_s", 900.0))
            break

    strat = get_strategy(strategy)
    if not strat.tabulated:
        # cold restart loses everything since the last restart — per-window
        # loss sampling cannot express that; run it through CampaignEngine
        raise ValueError(
            f"strategy {strategy!r} has no per-window closed form; "
            "execute it through the scenario engine instead"
        )
    if not strat.proactive and not periodicity_growth:
        p_h = 1.0  # growth curves are identically 1 at one hour
    c = strat.costs(CostContext(micro=micro, period_h=p_h))
    if c.lost_progress:
        return MCParams(
            J_s=spec.horizon_s,
            period_s=spec.period_s,
            per_window=per_window,
            reinstate_s=c.reinstate_s,
            overhead_s=c.overhead_s,
            lost_progress=True,
            fixed_lost_s=fixed_lost_s,
        )
    return MCParams(
        J_s=spec.horizon_s,
        period_s=spec.period_s,
        per_window=per_window,
        reinstate_s=c.reinstate_s,
        overhead_s=c.overhead_s,
        probe_per_hour_s=c.probe_s_per_hour,
        lost_progress=False,
        lead_s=c.predict_s,
    )


def mc_trajectories(
    spec,
    strategy: str,
    n_seeds: int = 1000,
    seed: int = 0,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    batch=None,
    detector="oracle",
    workload=None,
    autoscaler=None,
    tile_slots: int = 8,
    n_devices: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Monte-Carlo over full engine trajectories for ANY scenario family.

    Compiles ``n_seeds`` trials of ``spec`` (a :class:`ScenarioSpec` or a
    registered name) into one padded tape batch and folds them through
    the batched replay fold under ``strategy``'s vectorised cost table,
    on ``device`` (the card unless the caller asks for the CPU) — every
    seed at once, no loop over seeds. Each trial is *exactly* what
    ``CampaignEngine(spec, strategy, seed=k).run()`` computes.

    Returns summary stats over the surviving trials' totals (NaN when
    every trial is lost, e.g. ``spare_exhaustion``), the survival rate,
    mean counters, and the raw per-seed arrays under ``"trials"``. Pass a
    pre-compiled ``batch`` (:func:`compile_batch`) to amortise tape
    compilation across strategies; the same batch replays under any
    workload (``workload`` picks the registered cost model the trials
    are billed with when ``micro`` is not given — tapes are
    workload-independent, only the billing changes). ``tile_slots`` and
    ``n_devices`` set the fold's tile/split execution shape (the slots
    staged onto the device at a time, the cards the seed axis is split
    over) — both are bit-identity-preserving, only throughput changes.

    Every run also attaches ``"frames"``: the cross-seed time-in-state
    distribution (:func:`repro_torch.obs.metrics.aggregate_frames` over
    per-campaign :class:`~repro_torch.obs.metrics.MetricFrame` decompositions)
    — p5/p50/p95 per component for this (family × strategy × workload ×
    detector) cell, each frame summing to its billed total exactly. A
    scenario that declares a traffic spec raises: its SLO billing is a
    later slice of the port (ROADMAP Queue 1, item 8)."""
    from repro_torch.obs.metrics import aggregate_frames, aggregate_slo, frames_from_replay
    from repro_torch.scenarios import registry
    from repro_torch.scenarios.trajectory import compile_batch, replay_batch
    from repro_torch.telemetry.detector import Detector
    from repro_torch.workloads import resolve as resolve_workload

    spec = registry.get(spec) if isinstance(spec, str) else spec
    workload = resolve_workload(workload, spec, device=device)
    if batch is None:
        batch = compile_batch(spec, n_seeds, base_seed=seed)
    out = replay_batch(
        spec,
        batch,
        strategy,
        micro=micro,
        profile=profile,
        placement=placement,
        detector=detector,
        workload=workload,
        autoscaler=autoscaler,
        tile_slots=tile_slots,
        n_devices=n_devices,
        device=device,
    )
    frames = frames_from_replay(
        spec,
        out,
        getattr(strategy, "name", strategy),
        detector=detector.name if isinstance(detector, Detector) else detector,
        workload=workload.name,
        base_seed=seed,
    )
    totals = out["total_s"]
    ok = out["survived"]
    alive = totals[ok]
    stat = lambda f, d=np.nan: float(f(alive)) if alive.size else d
    slo = aggregate_slo(out)
    return {
        **({"slo": slo} if slo is not None else {}),
        "scenario": spec.name,
        "strategy": strategy,
        # the cost model the trials were billed under (advisory when an
        # explicit micro overrode it)
        "workload": workload.name,
        "n_seeds": int(batch.n_seeds),
        "survival_rate": float(np.mean(ok)),
        "mean_s": stat(np.mean),
        "std_s": stat(np.std),
        "p5_s": stat(lambda x: np.percentile(x, 5)),
        "p50_s": stat(lambda x: np.percentile(x, 50)),
        "p95_s": stat(lambda x: np.percentile(x, 95)),
        "mean_failed_at_s": float(np.mean(out["failed_at_s"][~ok])) if (~ok).any() else None,
        "counters": {
            k: float(np.mean(out[k]))
            for k in (
                "n_events",
                "n_handled",
                "n_migrations",
                "n_blacklisted",
                "n_reprovisioned",
            )
        },
        "frames": aggregate_frames(frames),
        "trials": out,
    }
