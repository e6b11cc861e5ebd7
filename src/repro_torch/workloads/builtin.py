"""The built-in workload models.

Two registrations — the matrix rows of the benchmark's per-workload
overhead report, in registration order:

``analytic``
    the regression anchor: the paper's genome-job sizing exactly as the
    seed simulator priced it (Z = 4, S_d = S_p = 512 MB). Its
    :meth:`micro` reduces to the seed ``measure_micro`` call argument-
    for-argument, so campaign records and the Table 1/2 CSVs stay
    byte-identical to the pre-workload-API repo.

``genome_search``
    the paper's application, calibrated against the port's real compute:
    the search/combine of :mod:`repro_torch.data.genome` is timed once
    per process and device (cached) and extrapolated to the paper-scale
    job (512 MB genome × 5000 patterns). Checkpoint payload stays the
    replicated input (what the paper's checkpoints write); the
    *migration* payload is the sub-job's live state — cursor plus
    partial hit table — which is what actually moves, and is orders of
    magnitude smaller.

The reference's ``train_llm`` and ``serve_decode`` price from the
roofline and the measured kernel surfaces, a later slice of the port
(ROADMAP Queue 1, item 8): :mod:`repro_torch.workloads.registry` raises
a ``KeyError`` that says so for either name.
"""
from __future__ import annotations

import time
from functools import lru_cache
from typing import Dict

from repro_torch.configs.paper_genome import CONFIG as GENOME_CFG
from repro_torch.workloads.base import (
    DEFAULT_SHARD_GRID,
    Workload,
    WorkloadCostTable,
    _transfer_surfaces,
)
from repro_torch.workloads.registry import register


def _profile(name: str):
    from repro_torch.core.cluster import get_profile

    return get_profile(name)


# ------------------------------------------------------------- analytic ---
@register("analytic", aliases=("paper",))
class AnalyticWorkload(Workload):
    """The seed simulator's scalar cost model as a workload.

    Sizing is the paper genome job verbatim (``configs/paper_genome``):
    Z = 4 dependencies, S_d = S_p = 512 MB replicated input. The step
    surface is the closed-form perfect-scaling window — 4 node-hours of
    work per window spread over the fleet — matching the accounting the
    tables assume."""

    description = "paper-calibrated scalar cost model (regression anchor)"

    def cost_table(
        self, profile: str = "placentia", n_nodes: int = 4
    ) -> WorkloadCostTable:
        prof = _profile(profile)
        s_d = int(GENOME_CFG.input_bytes)
        work_node_s = GENOME_CFG.window_hours * 3600.0 * GENOME_CFG.n_nodes
        step = tuple(work_node_s / (n * prof.node_speed) for n in DEFAULT_SHARD_GRID)
        return WorkloadCostTable(
            workload=self.name,
            z=GENOME_CFG.z_dependencies,
            state_bytes_per_shard=s_d,
            payload_bytes=s_d,
            n_shards=DEFAULT_SHARD_GRID,
            step_time_s=step,
            **_transfer_surfaces(prof, s_d, DEFAULT_SHARD_GRID),
        )


# -------------------------------------------------------- genome search ---
@lru_cache(maxsize=None)
def _genome_calibration(device: str) -> Dict[str, float]:
    """Time the real search/combine once per process and device.

    Returns measured rates: seconds per (base × pattern) searched (both
    strands, the ``search_chunk`` unit) and seconds per hit record
    combined. The device is synchronized before each clock read, so the
    search's time is the device's work, not its enqueue. Cached so every
    cost_table/bench/test call shares one measurement — the surfaces
    stay mutually consistent within a process."""
    from repro_torch.data.genome import GenomeSearchJob, make_genome
    from repro_torch.utils.device import resolve_device, synchronize

    dev = resolve_device(device)
    G, P = 1 << 16, 4
    genome, patterns, _ = make_genome(G, n_patterns=P, seed=11)
    job = GenomeSearchJob(genome, patterns, n_search=1, chunks_per_node=1, device=str(dev))
    job.run_sub_job_step(job.sub_job_states()[0])  # warm-up: upload and first launch
    state = {"node": 0, "cursor": 0, "hits": []}
    synchronize(dev)
    t0 = time.perf_counter()
    job.run_sub_job_step(state)
    synchronize(dev)
    search_s = max(time.perf_counter() - t0, 1e-6)

    hits = state["hits"] or [("chrI", 0, 14, 0, "+")]
    sample = (hits * (4096 // len(hits) + 1))[:4096]
    t0 = time.perf_counter()
    job.combine([{"node": 0, "cursor": 1, "hits": sample}])
    combine_s = max(time.perf_counter() - t0, 1e-9)

    return {
        "search_s_per_base_pattern": search_s / (G * P),
        "combine_s_per_hit": combine_s / len(sample),
        # hit volume scales with the dictionary (each pattern occurs a few
        # times per genome), NOT with bases x patterns searched
        "hits_per_pattern": len(state["hits"]) / P,
    }


@register("genome_search", aliases=("genome",))
class GenomeSearchWorkload(Workload):
    """The paper's application, calibrated against ``data/genome.py``.

    Step time extrapolates the search rate measured on ``device`` to the paper job
    (512 MB genome × 5000 patterns split over the fleet) plus the
    combiner's share. The migration payload is the live sub-job state —
    cursor + partial hit list (~64 B/record at the calibrated hit rate) —
    while checkpoints still write the replicated input, exactly as the
    paper's checkpoint figures assume."""

    description = "parallel genome pattern search (paper app, calibrated on the device)"
    REC_BYTES = 64  # one (chrom, start, end, pattern_id, strand) record

    def cost_table(
        self, profile: str = "placentia", n_nodes: int = 4
    ) -> WorkloadCostTable:
        prof = _profile(profile)
        cal = _genome_calibration(self.device)
        G = float(GENOME_CFG.input_bytes)  # one base per byte
        P = float(GENOME_CFG.n_patterns)
        total_hits = cal["hits_per_pattern"] * P
        step, n_grid = [], DEFAULT_SHARD_GRID
        for n in n_grid:
            search = cal["search_s_per_base_pattern"] * G * P / n
            combine = cal["combine_s_per_hit"] * total_hits  # serial reduction
            step.append((search + combine) / prof.node_speed)
        # S_p: the sub-job's migratable state at this fleet size
        payload = max(int(total_hits / max(n_nodes, 1)) * self.REC_BYTES, 1 << 10)
        s_d = int(GENOME_CFG.input_bytes)
        return WorkloadCostTable(
            workload=self.name,
            z=GENOME_CFG.z_dependencies,
            state_bytes_per_shard=s_d,
            payload_bytes=payload,
            n_shards=n_grid,
            step_time_s=tuple(step),
            **_transfer_surfaces(prof, s_d, n_grid),
        )
