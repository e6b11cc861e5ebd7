"""Unified fault-tolerance strategy API: one protocol + registry behind
the simulator, the live trainer and the scenario engine.

    from repro_torch.strategies import get, names, register

    strat = get("hybrid", placement="partition-aware")
    strat.costs(ctx)            # closed-form Table 1-2 accounting
    strat.attach(rt, payloads)  # live: drive the real migration machinery

Register a new strategy once and it appears in Tables 1-2, campaigns,
Monte-Carlo and the benchmark reports:

    @register("my_strategy")
    class MyStrategy(FaultToleranceStrategy):
        def costs(self, ctx): ...
        def on_failure(self, event, target): ...
"""
from repro_torch.strategies.base import (
    CostContext,
    FailureOutcome,
    FaultToleranceStrategy,
    StrategyCostTable,
    StrategyCosts,
    StrategyRow,
)
from repro_torch.strategies.placement import (
    NearestSpare,
    PartitionAware,
    PlacementPolicy,
    get_placement,
    placement_names,
    register_placement,
)
from repro_torch.strategies.registry import get, get_class, names, register, unregister
from repro_torch.strategies import costmodel

# NOTE: the built-in adapters (repro_torch.strategies.builtin) are loaded lazily
# by the registry on first get()/names() call — importing them here would
# close an import cycle through repro_torch.core (builtin drives the real
# Agent/VirtualCore/HybridUnit machinery, which sits on the runtime, which
# uses the placement policies defined in this package).

__all__ = [
    "CostContext",
    "FailureOutcome",
    "FaultToleranceStrategy",
    "NearestSpare",
    "PartitionAware",
    "PlacementPolicy",
    "StrategyCostTable",
    "StrategyCosts",
    "StrategyRow",
    "costmodel",
    "get",
    "get_class",
    "get_placement",
    "names",
    "placement_names",
    "register",
    "register_placement",
    "unregister",
]
