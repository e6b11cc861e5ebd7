"""The built-in workload models.

Four registrations — the matrix rows of the benchmark's per-workload
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

``train_llm``
    LLM pre-training: step time from the three-term roofline
    (:mod:`repro_torch.roofline.analysis`) over a ``configs/``
    architecture at the ``train_4k`` shape; recovery state is the full
    training state (f32 params + AdamW moments) sharded over the fleet —
    the state-heavy extreme, where checkpoint writes dwarf everything.

``serve_decode``
    autoregressive decoding behind the decode-attention kernel path: the
    per-shard state is only the KV cache slice (small), but every lost
    shard forces a cache rebuild/rebalance while latency-critical
    traffic waits — the small-state / high-rebalance-sensitivity extreme
    where the paper's ordering can invert (checkpointing a few dozen MB
    is cheaper than continuously probing for migration).

Both LLM workloads price on a device record (``hw=``, default
:data:`~repro_torch.roofline.analysis.H100_SXM`): the simulated fleet is
made of that device, so the port's default numbers for them differ from
the reference's, which prices on its own record.
"""
from __future__ import annotations

import time
from functools import lru_cache
from typing import Dict, Tuple

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


# ------------------------------------------------------------ train llm ---
@lru_cache(maxsize=None)
def _arch_params(arch: str) -> float:
    from repro_torch.configs import get_arch
    from repro_torch.roofline.analysis import param_count

    return param_count(get_arch(arch))["total"]


class _RooflineWorkload(Workload):
    """An LLM workload priced on one device record, ``hw`` (default
    :data:`~repro_torch.roofline.analysis.H100_SXM`). Two instances are
    equal, and hash alike, when their sizing and their record are: a record
    is part of what the cost table is a function of."""

    def __init__(self, hw=None):
        from repro_torch.roofline.analysis import H100_SXM

        self.hw = H100_SXM if hw is None else hw

    def _key(self):
        raise NotImplementedError

    def __eq__(self, other):
        return type(other) is type(self) and other._key() == self._key()

    def __hash__(self):
        return hash(self._key())


@register("train_llm", aliases=("train",))
class TrainLLMWorkload(_RooflineWorkload):
    """LLM pre-training priced from the roofline over a real config.

    Step time is the three-term roofline lower bound of one data-parallel
    training step on ``hw`` (compute = 6·N·tokens, memory = one pass over
    the training state + bf16 grads, collective = ring grad all-reduce);
    recovery state is the training state dict — f32 params plus AdamW
    first/second moments — sharded over the fleet. Z couples the whole
    fleet (a synchronous all-reduce stalls on any lost member)."""

    description = "data-parallel LLM pre-training (roofline-derived costs)"

    def __init__(self, arch: str = "gemma-2b", shape: str = "train_4k", hw=None):
        super().__init__(hw)
        self.arch = arch
        self.shape = shape

    def _key(self):
        return (self.arch, self.shape, self.hw)

    def _step_surface(self, n_grid: Tuple[int, ...]) -> Tuple[float, ...]:
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import SHAPES
        from repro_torch.roofline.analysis import model_flops, roofline_terms

        cfg = get_arch(self.arch)
        shape = SHAPES[self.shape]
        n_params = _arch_params(self.arch)
        flops = model_flops(cfg, shape)
        state_bytes = n_params * 4 * 3  # f32 params + adamw m/v
        out = []
        for n in n_grid:
            coll = 0.0 if n == 1 else 2.0 * (n - 1) / n * (2.0 * n_params / n)
            t = roofline_terms(
                flops / n, (state_bytes + 2.0 * n_params) / n, coll, self.hw
            )
            out.append(t["step_lower_bound_s"])
        return tuple(out)

    def cost_table(
        self, profile: str = "placentia", n_nodes: int = 4
    ) -> WorkloadCostTable:
        prof = _profile(profile)
        state_bytes = int(_arch_params(self.arch)) * 4 * 3
        per_shard = max(state_bytes // max(n_nodes, 1), 1)
        return WorkloadCostTable(
            workload=self.name,
            z=max(GENOME_CFG.z_dependencies, n_nodes),  # all-reduce coupling
            state_bytes_per_shard=per_shard,
            payload_bytes=per_shard,
            n_shards=DEFAULT_SHARD_GRID,
            step_time_s=self._step_surface(DEFAULT_SHARD_GRID),
            **_transfer_surfaces(prof, per_shard, DEFAULT_SHARD_GRID),
        )


# ---------------------------------------------------------- serve decode ---
@register("serve_decode", aliases=("serve",))
class ServeDecodeWorkload(_RooflineWorkload):
    """Autoregressive decoding over the decode-attention kernel path.

    Per-shard recovery state is only its KV-cache slice — bf16
    ``2 · n_kv_heads · head_dim`` bytes per token per layer, the exact
    tensor ``kernels/decode_attention.py`` streams — so checkpoints are
    tiny; but the workload is rebalance-sensitive: a lost shard's
    sessions re-prefill on the survivors while decode traffic waits,
    billed in the rebalance surface. Z stays small (router → replica).
    Step times are roofline bounds on ``hw``."""

    description = "KV-cache decode serving (small state, rebalance-sensitive)"

    def __init__(self, arch: str = "gemma-2b", batch: int = 8, seq_len: int = 2048, hw=None):
        super().__init__(hw)
        self.arch = arch
        self.batch = batch
        self.seq_len = seq_len

    def _key(self):
        return (self.arch, self.batch, self.seq_len, self.hw)

    def _cache_bytes(self) -> int:
        from repro_torch.configs import get_arch

        cfg = get_arch(self.arch)
        if cfg.attn_free:  # recurrent archs: per-row state, no KV growth
            per_row = cfg.n_layers * cfg.d_model * 4 * 2
        else:
            per_row = (
                self.seq_len * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
            )
        return int(self.batch * per_row)

    def cost_table(
        self, profile: str = "placentia", n_nodes: int = 4
    ) -> WorkloadCostTable:
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import ShapeCfg
        from repro_torch.roofline.analysis import model_flops, roofline_terms

        prof = _profile(profile)
        cfg = get_arch(self.arch)
        cache = self._cache_bytes()
        per_shard = max(cache // max(n_nodes, 1), 1)
        n_params = _arch_params(self.arch)
        shape = ShapeCfg("decode", self.seq_len, self.batch, "decode")
        flops = model_flops(cfg, shape)
        step = []
        for n in DEFAULT_SHARD_GRID:
            # one decode step: stream the cache slice + replicated params
            # (the memory-bound regime the flash-decode kernel lives in),
            # then gather one token row per shard
            coll = 0.0 if n == 1 else self.batch * cfg.d_model * 2.0 * (n - 1) / n
            t = roofline_terms(flops / n, cache / n + 2.0 * n_params, coll, self.hw)
            step.append(t["step_lower_bound_s"])
        return WorkloadCostTable(
            workload=self.name,
            z=2,
            state_bytes_per_shard=per_shard,
            payload_bytes=per_shard,
            n_shards=DEFAULT_SHARD_GRID,
            step_time_s=tuple(step),
            **_transfer_surfaces(prof, per_shard, DEFAULT_SHARD_GRID),
        )
