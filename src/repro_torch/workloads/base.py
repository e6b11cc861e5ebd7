"""The pluggable workload-model API: calibrated cost surfaces connecting
the FT simulator to the repo's real compute layers.

The paper validates its multi-agent fault tolerance on ONE workload —
parallel genome pattern searching — and the simulator inherited that
choice as a single scalar :class:`~repro_torch.core.sim.MicroCosts` record
baked into every campaign. Recovery cost, however, is dominated by the
workload's state size and recomputation profile (Treaster, cs/0501002),
and per-task recovery semantics — not one global cost — are what the
hybrid-workflow FT literature argues for (Mulone et al., 2407.05337).
This module makes the workload a third pluggable axis, alongside the
strategies (``repro_torch.strategies``) and detectors (``repro_torch.telemetry``):

* a :class:`Workload` describes one application's cost structure — how
  long a synchronous step takes at a given shard count, how many bytes a
  shard's migratable state is, what a checkpoint write/restore of that
  state costs, what moving or rebalancing a victim shard costs;
* :meth:`Workload.cost_table` tabulates those surfaces as a
  :class:`WorkloadCostTable` (hashable, tensor-consumable via
  :meth:`WorkloadCostTable.surfaces` / :meth:`WorkloadCostTable.at`);
* :meth:`Workload.micro` binds the workload into the existing billing
  contract: it prices the measured/modelled micro-cost record from the
  workload's calibrated sizes, so **every** consumer of ``MicroCosts`` —
  the closed-form tables, :class:`~repro_torch.scenarios.engine.CampaignEngine`,
  and the batched replay fold in ``scenarios/trajectory.py`` — runs
  under the workload without further dispatch. Because the engine and
  the fold share the one memoized record, trial-for-trial parity holds
  under every workload by construction.

Register implementations with :func:`repro_torch.workloads.registry.register`;
anything in the registry is immediately campaign-able
(``CampaignEngine(spec, approach, workload="my_workload")``), Monte-
Carlo-able (``mc_trajectories(..., workload=...)``) and appears in the
benchmark's per-workload overhead matrix.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

#: shard counts every builtin tabulates its surfaces at (powers of two up
#: to a full pod; :meth:`WorkloadCostTable.at` interpolates between them).
#: The grid reaches 1024 so fleet-scale scenario families (256+ serving
#: shards) sit inside the tabulated range instead of extrapolating off
#: its edge.
DEFAULT_SHARD_GRID: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclass(frozen=True)
class WorkloadCostTable:
    """One workload's vectorised cost surfaces, tabulated over shard counts.

    All per-shard-count fields are parallel tuples over ``n_shards`` (a
    frozen dataclass of tuples stays hashable, so tables can key jit
    caches the way :class:`~repro_torch.strategies.base.StrategyCostTable`
    does); :meth:`surfaces` exposes them as float64 tensors for vectorised
    consumers and :meth:`at` interpolates every surface at one shard
    count. Scalar sizing fields feed the micro-cost contract:

    ``z``
        dependency fan-in of the workload's reduction topology (the
        hybrid strategy's Rules 1-3 input);
    ``state_bytes_per_shard``
        S_d — the bytes one shard stages / checkpoints (recovery payload);
    ``payload_bytes``
        S_p — the bytes the migration metadata scales with (the live
        process image a proactive mechanism actually moves).
    """

    workload: str
    z: int
    state_bytes_per_shard: int
    payload_bytes: int
    n_shards: Tuple[int, ...]
    step_time_s: Tuple[float, ...]  # synchronous step seconds at n shards
    ckpt_write_s: Tuple[float, ...]  # full-job checkpoint write seconds
    ckpt_restore_s: Tuple[float, ...]  # checkpoint restore seconds
    migrate_shard_s: Tuple[float, ...]  # move one victim shard's state
    rebalance_shard_s: Tuple[float, ...]  # spread one shard over survivors

    SURFACE_FIELDS = (
        "step_time_s",
        "ckpt_write_s",
        "ckpt_restore_s",
        "migrate_shard_s",
        "rebalance_shard_s",
    )

    def __post_init__(self):
        n = len(self.n_shards)
        for f in self.SURFACE_FIELDS:
            if len(getattr(self, f)) != n:
                raise ValueError(
                    f"{self.workload}: surface {f!r} has {len(getattr(self, f))} "
                    f"entries for {n} shard counts"
                )

    def surfaces(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The cost surfaces as float64 tensors on ``device`` keyed by field
        name (plus the ``n_shards`` grid) — the structure-of-arrays form
        the batched consumers index and interpolate."""
        out = {"n_shards": torch.tensor(self.n_shards, dtype=torch.float64, device=device)}
        for f in self.SURFACE_FIELDS:
            out[f] = torch.tensor(getattr(self, f), dtype=torch.float64, device=device)
        return out

    def at(self, n_shards, device="cpu") -> Dict[str, torch.Tensor]:
        """Every surface linearly interpolated at ``n_shards`` (a number,
        an array or a tensor, whose device wins), float64 and equal to
        ``np.interp`` on the grid's points and between them."""
        if isinstance(n_shards, torch.Tensor):
            device = n_shards.device
        q = torch.as_tensor(np.asarray(n_shards, np.float64), device=device)
        surf = self.surfaces(device)
        grid = surf.pop("n_shards")
        return {f: _interp(q, grid, v) for f, v in surf.items()}

    def step_time(self, n_shards):
        """``step_time_s`` interpolated at ``n_shards`` (vectorised)."""
        return self.at(n_shards)["step_time_s"]


class Workload(ABC):
    """Base class for every workload model.

    Implementations override :meth:`cost_table`; the default
    :meth:`micro` then prices the standard micro-cost record from the
    table's calibrated sizes — executing the real migration machinery at
    the workload's Z and staging/checkpointing the workload's state
    bytes — which is all the engine, the closed-form accountant and the
    replay fold need. Override :meth:`micro` only to change *how* the
    record is derived (the ``analytic`` anchor keeps the seed call
    verbatim)."""

    name: str = "?"
    description: str = ""
    #: where a workload that calibrates against real compute times it
    #: (``genome_search`` runs the genome search there);
    #: :func:`repro_torch.workloads.resolve` sets it
    device: str = "cuda"

    @abstractmethod
    def cost_table(
        self, profile: str = "placentia", n_nodes: int = 4
    ) -> WorkloadCostTable:
        """Tabulate this workload's cost surfaces on one cluster profile."""

    def micro(self, profile: str = "placentia", n_nodes: int = 4):
        """The workload-calibrated :class:`~repro_torch.core.sim.MicroCosts`.

        ``measure_micro`` is memoized on its full argument tuple, so
        every consumer of the same (workload, profile, n_nodes) shares
        one record — the engine-vs-replay parity guarantee."""
        from repro_torch.core.sim import measure_micro

        t = self.cost_table(profile, n_nodes)
        return measure_micro(
            profile,
            n_nodes=n_nodes,
            z=t.z,
            s_d_bytes=t.state_bytes_per_shard,
            s_p_bytes=t.payload_bytes,
        )

    def measured_step_surface(self, n_shards: Tuple[int, ...] = (1, 2, 4), **shape):
        """The *measured* step-time surface of the workload's kernel hot
        path (the reference times its flash-decode / flash-attention
        kernels per shard count). It needs the port's profiling module and
        the LLM workloads, a later slice."""
        raise NotImplementedError(
            f"{self.name}: measured step surfaces wait for obs/profile and the LLM "
            "workloads (ROADMAP Queue 1, item 8)"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


def _interp(q: torch.Tensor, grid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``np.interp(q, grid, vals)`` for finite float64 tensors, in numpy's
    own arithmetic: ``slope * (q - x_j) + y_j`` on the interval
    ``x_j <= q < x_{j+1}``, the end values outside the grid and at its last
    point."""
    n = grid.shape[0]
    j = (torch.searchsorted(grid, q, right=True) - 1).clamp(0, n - 2)
    x0, x1 = grid[j], grid[j + 1]
    y0, y1 = vals[j], vals[j + 1]
    slope = (y1 - y0) / (x1 - x0)
    out = slope * (q - x0) + y0
    out = torch.where(q >= grid[n - 1], vals[n - 1], out)
    return torch.where(q < grid[0], vals[0], out)


def _transfer_surfaces(
    profile, state_bytes_per_shard: int, n_shards: Tuple[int, ...]
) -> Dict[str, Tuple[float, ...]]:
    """Shared byte→seconds arithmetic for checkpoint/migration surfaces.

    Checkpoint payload is every shard's state written to (read from) the
    stable-storage path; migration moves one victim shard's state over
    the node NIC; a rebalance streams that shard to its ``n-1`` survivors
    in parallel slices (so it cheapens with the fleet, but never below
    one NIC transfer of a slice)."""
    s = float(state_bytes_per_shard)
    ckpt_w, ckpt_r, mig, reb = [], [], [], []
    for n in n_shards:
        total = s * n
        ckpt_w.append(total / profile.ckpt_server_bw)
        ckpt_r.append(total / profile.ckpt_restore_bw)
        mig.append(s / profile.node_bw + s / profile.ser_bytes_per_s)
        reb.append(s / max(n - 1, 1) / profile.node_bw * n + profile.msg_latency_s * n)
    return {
        "ckpt_write_s": tuple(ckpt_w),
        "ckpt_restore_s": tuple(ckpt_r),
        "migrate_shard_s": tuple(mig),
        "rebalance_shard_s": tuple(reb),
    }
