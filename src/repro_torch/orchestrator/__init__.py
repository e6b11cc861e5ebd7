"""Live orchestration: supervise real processes, plan with the simulator.

The fifth subsystem. Everything before it bills hypothetical campaigns;
this package actually launches, kills, restarts and migrates worker
processes, with the existing simulator demoted to the planning oracle
the daemon consults (strategy choice, predicted makespan, drift
re-planning) and the existing detector/strategy/trace axes reused
unforked at runtime. The port of ``repro.orchestrator``: its workers run
on the card unless the caller asks for the CPU.

    from repro_torch.orchestrator import registry          # the injector axis
    from repro_torch.orchestrator.daemon import OrchestratorDaemon
    from repro_torch.orchestrator.plan import make_live_plan

Exports resolve lazily — importing the package never pulls asyncio,
subprocess or torch, so the worker subprocess and the ``launch/``
entrypoints can import the exit-code contract for free.
"""
from __future__ import annotations

from repro_torch.orchestrator import registry
from repro_torch.orchestrator.contract import (
    EXIT_FAULT_INJECTED,
    EXIT_NAMES,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_STALLED,
    classify_exit,
)

_LAZY = {
    "Spool": ("repro_torch.orchestrator.spool", "Spool"),
    "Injector": ("repro_torch.orchestrator.injector", "Injector"),
    "Injection": ("repro_torch.orchestrator.injector", "Injection"),
    "OrchestratorDaemon": ("repro_torch.orchestrator.daemon", "OrchestratorDaemon"),
    "SubprocessLauncher": ("repro_torch.orchestrator.daemon", "SubprocessLauncher"),
    "WorkerHandle": ("repro_torch.orchestrator.daemon", "WorkerHandle"),
    "LiveReport": ("repro_torch.orchestrator.daemon", "LiveReport"),
    "LivePlan": ("repro_torch.orchestrator.plan", "LivePlan"),
    "make_live_plan": ("repro_torch.orchestrator.plan", "make_live_plan"),
    "choose_strategy": ("repro_torch.orchestrator.plan", "choose_strategy"),
    "DriftMonitor": ("repro_torch.orchestrator.plan", "DriftMonitor"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


__all__ = [
    "EXIT_FAULT_INJECTED",
    "EXIT_NAMES",
    "EXIT_OK",
    "EXIT_PREEMPTED",
    "EXIT_STALLED",
    "classify_exit",
    "registry",
    *sorted(_LAZY),
]
