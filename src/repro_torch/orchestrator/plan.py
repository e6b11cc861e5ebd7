"""The planning oracle: the simulator, consulted by the daemon.

The port of ``repro.orchestrator.plan``; every question below is asked
on ``device`` (the card unless the caller asks for the CPU). Before
launch the daemon asks this module three questions:

1. **Which strategy?** :func:`choose_strategy` runs
   :func:`~repro_torch.scenarios.montecarlo.mc_trajectories` for every
   candidate over one shared compiled tape batch, keeps the candidates
   with the best survival rate, and picks the lowest mean makespan.
2. **What should the run cost?** :func:`predicted_makespan_s` bills the
   exact ``(spec, seed)`` trial the injector will replay through the
   Python :class:`~repro_torch.scenarios.engine.CampaignEngine` — same seed,
   same detector, same workload — so live and predicted makespans are
   the same campaign priced two ways.
3. **How fast is a step really?** :func:`measure_step_wall_s` times the
   workload's real step program in-process on the device (and attaches
   ``Workload.measured_step_surface()`` /
   :func:`~repro_torch.obs.profile.time_kernel` numbers when the
   workload has a kernel hot path: ``train_llm`` launches the CUDA
   flash-attention kernel on the card), calibrating the billed
   ``step_time_s`` cost tables against the machine the daemon runs on.

:func:`make_live_plan` folds the answers into a :class:`LivePlan`: the
run executes in *scaled time* (``time_scale`` simulated seconds per wall
second), each of ``n_steps`` paced steps representing ``step_sim_s`` of
the horizon, with the strategy's probe cost folded into the pace so a
failure-free live run lands exactly on the engine's
``horizon + probe`` bill.

:class:`DriftMonitor` watches the live run for the spec lying —
observed failure rate or measured step latency diverging beyond a
ratio band — and tells the daemon to re-plan;
:func:`scale_failure_rate` rewrites the spec to the observed intensity
for the re-plan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.scenarios.spec import FailureProcessSpec, ScenarioSpec

#: strategies the oracle considers when the caller doesn't narrow the field
DEFAULT_CANDIDATES = ("central_single", "agent", "core", "hybrid")

#: steps per checkpoint period when the caller doesn't set a resolution
DEFAULT_STEPS_PER_PERIOD = 2


# -------------------------------------------------------------- strategy ---
def choose_strategy(
    spec: ScenarioSpec,
    candidates: Tuple[str, ...] = DEFAULT_CANDIDATES,
    *,
    n_seeds: int = 200,
    seed: int = 0,
    detector: str = "ewma_straggler",
    workload=None,
    device="cuda",
) -> Tuple[str, Dict[str, Dict]]:
    """Monte-Carlo every candidate over one shared tape batch; return
    ``(winner, scores)``. Survival dominates cost: only candidates tied
    for the best survival rate compete on mean makespan."""
    from repro_torch.scenarios.montecarlo import mc_trajectories
    from repro_torch.scenarios.trajectory import compile_batch

    batch = compile_batch(spec, n_seeds, seed)
    scores: Dict[str, Dict] = {}
    for name in candidates:
        r = mc_trajectories(
            spec, name, n_seeds=n_seeds, seed=seed, batch=batch,
            detector=detector, workload=workload, device=device,
        )
        scores[name] = {
            "mean_s": r["mean_s"],
            "p95_s": r["p95_s"],
            "survival_rate": r["survival_rate"],
        }
    best_survival = max(s["survival_rate"] for s in scores.values())
    finalists = [n for n, s in scores.items() if s["survival_rate"] >= best_survival]
    winner = min(finalists, key=lambda n: scores[n]["mean_s"])
    return winner, scores


def predicted_makespan_s(
    spec: ScenarioSpec,
    strategy: str,
    *,
    seed: int = 0,
    detector: str = "ewma_straggler",
    workload=None,
    device="cuda",
) -> float:
    """Engine-billed makespan for the exact trial the injector replays."""
    from repro_torch.scenarios.engine import CampaignEngine

    res = CampaignEngine(
        spec, strategy, seed=seed, detector=detector, workload=workload, device=device
    ).run()
    return float(res.total_s)


# ----------------------------------------------------------- calibration ---
def measure_step_wall_s(
    workload: str,
    *,
    n_shards: int,
    n_steps: int,
    seed: int = 0,
    n_probe_steps: int = 2,
    clock=time.monotonic,
    device="cuda",
) -> Dict:
    """Time the workload's real step program in-process on ``device``
    (each step returns with the device's work done).

    Returns ``{"step_wall_s", "backend", "surface"}`` where ``surface``
    is the kernel step-time surface for workloads with a kernel hot path
    (None otherwise — analytic/genome time their own step here)."""
    from repro_torch.orchestrator.worker import make_program

    prog = make_program(
        workload, seed, n_shards, max(n_steps, n_probe_steps + 1), 0, device=device
    )
    prog.step()  # the device's first launches outside the timed window
    t0 = clock()
    for _ in range(n_probe_steps):
        prog.step()
    measured_s = (clock() - t0) / n_probe_steps

    surface = None
    backend = "python"
    try:
        from repro_torch.workloads import registry as workload_registry

        surface = workload_registry.get(workload).measured_step_surface(
            n_shards=(n_shards,), device=device
        )
        if surface is not None:
            backend = surface.get("backend", "unknown")
    except KeyError:
        pass  # live-only workload name with no registered cost model
    return {"step_wall_s": float(measured_s), "backend": backend, "surface": surface}


# ------------------------------------------------------------- the plan ---
@dataclass
class LivePlan:
    """Everything the daemon needs to run one live campaign."""

    spec: ScenarioSpec
    strategy: str
    seed: int
    detector: str
    workload: str
    time_scale: float  # simulated seconds per wall second
    n_steps: int  # per shard
    step_sim_s: float  # simulated seconds one step represents
    step_wall_s: float  # paced wall duration of one step (probe folded in)
    ckpt_every_steps: int
    predicted_total_s: float  # engine bill for this exact (spec, seed)
    scores: Dict[str, Dict] = field(default_factory=dict)  # per-candidate MC
    calibration: Dict = field(default_factory=dict)  # measure_step_wall_s output
    device: str = "cuda"  # where the oracle, the daemon's detector and the workers run

    def to_dict(self) -> Dict:
        return {
            "strategy": self.strategy,
            "seed": self.seed,
            "detector": self.detector,
            "workload": self.workload,
            "time_scale": self.time_scale,
            "n_steps": self.n_steps,
            "step_sim_s": self.step_sim_s,
            "step_wall_s": self.step_wall_s,
            "ckpt_every_steps": self.ckpt_every_steps,
            "predicted_total_s": self.predicted_total_s,
            "scores": self.scores,
            "calibration": {
                k: v for k, v in self.calibration.items() if k != "surface"
            },
        }


def make_live_plan(
    spec: ScenarioSpec,
    *,
    time_scale: float,
    seed: Optional[int] = None,
    strategy: Optional[str] = None,
    candidates: Tuple[str, ...] = DEFAULT_CANDIDATES,
    detector: str = "ewma_straggler",
    workload: Optional[str] = None,
    n_seeds: int = 200,
    steps_per_period: int = DEFAULT_STEPS_PER_PERIOD,
    calibrate: bool = True,
    device="cuda",
) -> LivePlan:
    """Consult the oracle and lay out the scaled-time execution grid.

    ``n_steps * step_sim_s == horizon_s`` exactly, and a checkpoint lands
    on every simulated period boundary (``ckpt_every_steps`` steps), so
    lost-work granularity matches the engine's billing windows.
    ``device`` is refused up front when it is a card that is not there."""
    from repro_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    seed = spec.seed if seed is None else int(seed)
    workload = workload or spec.workload or "analytic"

    scores: Dict[str, Dict] = {}
    if strategy is None:
        strategy, scores = choose_strategy(
            spec, candidates, n_seeds=n_seeds, seed=seed,
            detector=detector, workload=workload, device=device,
        )

    n_periods = max(1, round(spec.horizon_s / spec.period_s))
    n_steps = n_periods * steps_per_period
    step_sim_s = spec.horizon_s / n_steps

    # fold the strategy's probe bill into the pace: every shard steps in
    # parallel, so per-step padding grows the max-completion time by
    # exactly the probe total — the engine's single probe line item
    from repro_torch.strategies import registry as strategy_registry

    probe_sim_s = strategy_registry.get(strategy).tick_costs() * spec.horizon_s / 3600.0
    step_wall_s = (step_sim_s + probe_sim_s / n_steps) / time_scale

    calibration: Dict = {}
    if calibrate:
        calibration = measure_step_wall_s(
            workload, n_shards=spec.n_nodes, n_steps=n_steps, seed=seed, device=device
        )

    predicted = predicted_makespan_s(
        spec, strategy, seed=seed, detector=detector, workload=workload, device=device
    )
    return LivePlan(
        spec=spec,
        strategy=strategy,
        seed=seed,
        detector=detector,
        workload=workload,
        time_scale=float(time_scale),
        n_steps=int(n_steps),
        step_sim_s=float(step_sim_s),
        step_wall_s=float(step_wall_s),
        ckpt_every_steps=int(steps_per_period),
        predicted_total_s=float(predicted),
        scores=scores,
        calibration=calibration,
        device=device,
    )


# ------------------------------------------------------------------ drift ---
def scale_failure_rate(spec: ScenarioSpec, ratio: float) -> ScenarioSpec:
    """A copy of ``spec`` with its failure intensity scaled by ``ratio``
    (the observed/declared rate the drift monitor measured). Count-like
    process knobs (``per_window``, burst ``k``) scale and round; other
    processes are left alone."""
    d = spec.to_dict()
    for p in d["processes"]:
        params = p["params"]
        for knob in ("per_window", "k"):
            if knob in params:
                params[knob] = max(1, round(params[knob] * ratio))
    out = ScenarioSpec.from_dict(d)
    assert all(isinstance(p, FailureProcessSpec) for p in out.processes)
    return out


class DriftMonitor:
    """Watches a live run for the spec diverging from reality.

    Two drift signals, both ratio-banded:

    * **failure rate** — observed failures per simulated second vs the
      spec's declared expectation (needs ``min_failures`` observations
      before it will fire, so one unlucky event isn't "drift");
    * **step time** — EWMA of measured step latencies vs the calibrated
      pace (a machine slower than calibration skews every makespan).
    """

    def __init__(
        self,
        *,
        expected_failures: float,
        horizon_s: float,
        step_wall_s: float,
        rate_band: float = 1.8,
        step_band: float = 1.8,
        min_failures: int = 2,
        ewma_alpha: float = 0.3,
    ):
        self.expected_rate_per_s = max(expected_failures, 1e-9) / horizon_s
        self.step_wall_s = step_wall_s
        self.rate_band = rate_band
        self.step_band = step_band
        self.min_failures = min_failures
        self.ewma_alpha = ewma_alpha
        self.n_failures = 0
        self.step_ewma_s: Optional[float] = None

    def observe_failure(self) -> None:
        self.n_failures += 1

    def observe_step(self, step_latency_s: float) -> None:
        if self.step_ewma_s is None:
            self.step_ewma_s = step_latency_s
        else:
            a = self.ewma_alpha
            self.step_ewma_s = a * step_latency_s + (1 - a) * self.step_ewma_s

    def rate_ratio(self, t_sim_s: float) -> float:
        if t_sim_s <= 0:
            return 1.0
        return (self.n_failures / t_sim_s) / self.expected_rate_per_s

    def drifted(self, t_sim_s: float) -> Optional[Dict]:
        """None, or ``{"cause", "ratio"}`` when a signal leaves its band."""
        if self.n_failures >= self.min_failures:
            r = self.rate_ratio(t_sim_s)
            if r >= self.rate_band:
                return {"cause": "failure_rate", "ratio": float(r)}
        if self.step_ewma_s is not None and self.step_wall_s > 0:
            r = self.step_ewma_s / self.step_wall_s
            if r >= self.step_band:
                return {"cause": "step_time", "ratio": float(r)}
        return None
