"""Pluggable workload models: calibrated cost surfaces for the FT stack.

    from repro_torch.workloads import registry
    wl = registry.get("genome_search")
    table = wl.cost_table("placentia", n_nodes=4)   # vectorised surfaces
    micro = wl.micro("placentia", n_nodes=4)        # campaign billing record

The workload is the third pluggable axis of a campaign, alongside the
strategy (``repro_torch.strategies``) and the detector (``repro_torch.telemetry``):

    CampaignEngine(spec, "core", workload="genome_search").run()
    mc_trajectories(spec, "hybrid", workload="genome_search")
"""
from repro_torch.workloads import registry
from repro_torch.workloads.base import DEFAULT_SHARD_GRID, Workload, WorkloadCostTable
from repro_torch.workloads.registry import get, get_class, names, register, unregister


def resolve(workload, spec=None, device="cuda") -> Workload:
    """One resolution rule for every ``workload=`` parameter: an explicit
    instance or name wins, then the spec's declared workload, then the
    ``analytic`` anchor (the seed cost model, bit-for-bit). A workload
    made from a name calibrates on ``device``."""
    if isinstance(workload, Workload):
        return workload
    if workload is None:
        workload = getattr(spec, "workload", None) or "analytic"
    wl = registry.get(workload)
    wl.device = str(device)
    return wl


__all__ = [
    "DEFAULT_SHARD_GRID",
    "Workload",
    "WorkloadCostTable",
    "get",
    "get_class",
    "names",
    "register",
    "registry",
    "resolve",
    "unregister",
]
