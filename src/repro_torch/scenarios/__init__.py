"""Scenario engine: declarative multi-failure campaigns, the batched
trajectory replay (a float64 torch fold on the card), and vectorised
Monte-Carlo over BOTH the closed-form model and full engine trajectories.

    from repro_torch.scenarios import mc_trajectories, registry
    from repro_torch.scenarios.engine import CampaignEngine

    spec = registry.get("rack_outage")
    result = CampaignEngine(spec, approach="hybrid").run()   # one trial
    mc = mc_trajectories(spec, "hybrid", n_seeds=2000)       # all at once
"""
from repro_torch.scenarios import registry
from repro_torch.scenarios.engine import CampaignEngine, CampaignResult
from repro_torch.scenarios.montecarlo import (
    MCParams,
    mc_totals,
    mc_trajectories,
    python_loop_baseline,
)
from repro_torch.scenarios.spec import FailureProcessSpec, ScenarioSpec, degrade_slowdown_s
from repro_torch.scenarios.trajectory import (
    TapeBatch,
    TrajectoryTape,
    compile_batch,
    compile_tape,
    replay_batch,
)


def __getattr__(name):
    if name == "APPROACHES":
        # derived live from the strategy registry (a from-import here
        # would freeze the tuple at package-import time and miss
        # strategies registered afterwards)
        from repro_torch.scenarios import engine

        return engine.APPROACHES
    raise AttributeError(name)

__all__ = [
    "APPROACHES",
    "CampaignEngine",
    "CampaignResult",
    "FailureProcessSpec",
    "MCParams",
    "ScenarioSpec",
    "TapeBatch",
    "TrajectoryTape",
    "compile_batch",
    "compile_tape",
    "degrade_slowdown_s",
    "mc_totals",
    "mc_trajectories",
    "python_loop_baseline",
    "registry",
    "replay_batch",
]
