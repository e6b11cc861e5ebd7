"""Batched trajectory engine: compile campaign event streams to padded/
masked structure-of-arrays tapes, then replay thousands of trials at once
in one float64 torch fold on the card.

The paper's headline comparison (multi-agent ~10 % overhead vs ~90 % for
checkpointing) is a mean over thousands of stochastic trials, and the
fault-recovery literature (Treaster, cs/0501002) stresses that recovery-
cost *distributions* — tails, not just means — are what distinguish
reactive from proactive schemes. ``montecarlo.mc_totals`` vectorises only
the closed-form window model; the scenario families that actually
differentiate the approaches (cascade, rack, flaky, burst, partition) run
one Python :class:`~repro_torch.scenarios.engine.CampaignEngine` at a
time.

This module splits scenario execution into two layers:

**Trajectory compiler** (:func:`compile_tape` / :func:`compile_batch`)
    resolves one ``(ScenarioSpec, seed)`` into a fixed-shape event tape:
    per-slot times, victim hosts, predictability / during-checkpoint
    flags, pre-sampled repair-delay draws (consumed in schedule order, so
    heavy-tailed lognormal repairs keep the engine's exact rng sequence),
    *parent pointers* for dynamically-retargeted cascade chains (a
    cascade's victim is the host the parent's sub-job migrated TO —
    unknowable statically, so the slot stores which earlier slot to ask),
    and the statically-resolved network-partition component map per slot.
    Numpy, the reference's code as it is, so the tapes are bitwise the
    reference's.

**Replay fold** (:func:`replay_batch`)
    a torch fold over the tape slots with the state of every seed at
    once: cluster control state — blacklist strikes, the spare-pool FIFO
    (entry-sequence numbers reproduce the engine's list order through
    removals and repair re-appends), occupancy, per-host repair clocks,
    dependency degrees for the hybrid's Rules 1-3 Z-negotiation, cold-
    restart attempt clocks — lives in ``[seeds, hosts]`` tensors (bool,
    int32, float64) on one device and advances slot by slot in a Python
    loop. Every ``.at[v]`` read and update of the reference becomes a
    ``gather`` / ``scatter`` along the host axis with a per-seed index
    ``[S, 1]``. Per-event costs come from the strategy's
    :class:`~repro_torch.strategies.base.StrategyCostTable`.

:class:`CampaignEngine` remains the single-trial reference semantics (it
consumes the same compiled tape, driving the real Agent/VirtualCore/
HybridUnit machinery), and the differential tests assert the fold matches
it trial-for-trial on identical seeds, and matches the reference's own
``replay_batch`` bit for bit.

**Float64, bit for bit.** The fold does the reference's operations in the
reference's order (``lost + where(handled, ...)`` per slot, ``horizon_s +
lost + reinstate + overhead + probe``, ``c_probe * span_s / 3600.0``,
``floor(t / period_s) * period_s``). Eager torch runs each operation as
its own kernel, so nothing is contracted into a fused multiply-add; the
fold is not wrapped in ``torch.compile`` and uses no fused calls. A
divisor is always a tensor on the fold's device: CUDA divides by a CPU
scalar as a multiplication by its reciprocal, which may lose a bit.
Ties resolve as the reference's do: ``torch.argmin`` over float64 and
``torch.argmax`` over an integer mask return the first index, and ``%`` on
int tensors floors as Python's does (``(v - 1) % H`` at ``v = 0`` is
``H - 1``).

**Execution shape.** Repair-order ranking switches with the host-axis
width from the O(H²) pairwise matrix to a stable ``argsort`` (bit-
identical on the due hosts — see ``_PAIRWISE_RANK_MAX_HOSTS``); the
per-slot partition component map collapses to width 1 whenever the family
opens no partition cut; the tape is staged onto the device ``tile_slots``
slots at a time (from pinned host memory on the card); and the seed axis
splits over ``n_devices`` cards (run in turn on the CPU). None of these
changes a bit of any output. Cost-table *values* travel as a float64
``[8]`` coefficient tensor, so one cached program serves every strategy
that shares a structural :class:`_TableStatic` shape —
:func:`replay_cache_stats` reports the hit rate.

**Launches.** The fold launches ~150 small kernels a slot (147-152 on an
H100 at ``mc_stress`` and ``fleet_stress`` sizes), the same for any seed
count: it is bound by launches, not bytes (``PERF.md``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rules import SD_THRESHOLD_BYTES, Z_THRESHOLD
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.strategies import registry as strategy_registry
from repro_torch.strategies.base import CostContext, FaultToleranceStrategy, StrategyCostTable
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes

__all__ = [
    "TrajectoryTape",
    "TapeBatch",
    "compile_tape",
    "compile_batch",
    "default_seed_devices",
    "replay_batch",
    "replay_cache_stats",
    "replay_program",
]


# ======================================================================
# Layer 1: the trajectory compiler
# ======================================================================
@dataclass
class TrajectoryTape:
    """One seed's campaign, resolved to fixed-shape slot arrays.

    Slots are time-ordered; cascade children carry ``parent >= 0`` and
    ``victim == -1`` (the replay — Python engine or torch fold — fills
    the victim in from the parent slot's migration target, and skips the
    slot entirely when the parent never migrated)."""

    spec_name: str
    seed: int
    n_hosts: int  # n_nodes + n_spares
    times: np.ndarray  # float64 [n]
    victim: np.ndarray  # int32   [n]  (-1: resolved from parent at replay)
    parent: np.ndarray  # int32   [n]  (-1: root event from the spec stream)
    predictable: np.ndarray  # bool [n]
    during_ckpt: np.ndarray  # bool [n]
    repair_draws: np.ndarray  # float64 [n], consumed in schedule order
    causes: List[str] = field(default_factory=list)
    # rack-correlated slots (cause == "rack"): detector verdict tapes use
    # this to apply correlated telemetry drift per event
    rack_corr: Optional[np.ndarray] = None  # bool [n]
    # static partition state per slot: component id per host (-1 unmapped)
    # and whether any cut is open at the slot's time. Families with no
    # partition timeline compact the host axis to width 1 (all -1) so a
    # tape never materialises an O(n_slots x H) array it will not use.
    part_active: Optional[np.ndarray] = None  # bool [n]
    part_comp: Optional[np.ndarray] = None  # int32 [n, H] ([n, 1] if no cuts)
    # engine-facing form of the same timeline: [(t, comp_map-or-None)]
    partition_changes: List[Tuple[float, Optional[Dict[int, int]]]] = field(
        default_factory=list
    )

    @property
    def n_slots(self) -> int:
        return int(self.times.shape[0])


def compile_tape(spec: ScenarioSpec, seed: Optional[int] = None) -> TrajectoryTape:
    """Resolve one ``(spec, seed)`` trial into a :class:`TrajectoryTape`.

    Strategy-independent: control flow (victims, targets, blacklisting,
    repairs) evolves identically under every strategy that uses the same
    placement policy, so one tape replays under any cost table."""
    base_seed = spec.seed if seed is None else seed
    evs = spec.events(base_seed)
    horizon_s = spec.horizon_s
    H = spec.n_nodes + spec.n_spares

    n0 = len(evs)
    times: List[float] = [e.t for e in evs]
    victim: List[int] = [e.node for e in evs]
    parent: List[int] = [-1] * n0
    pred: List[bool] = [e.predictable for e in evs]
    during: List[bool] = [e.during_checkpoint for e in evs]
    causes: List[str] = [e.cause for e in evs]
    # pre-allocate cascade chains: times are static (t + k*delay); only the
    # victim is dynamic. Children appended AFTER the originals so a stable
    # sort reproduces the engine heap's tie-break (pushed-later pops later).
    for i, ev in enumerate(evs):
        if not ev.cascade or int(ev.cascade.get("depth", 0)) <= 0:
            continue
        delay_s = float(ev.cascade.get("delay_s", 120.0))
        par, t = i, float(ev.t)
        for _ in range(int(ev.cascade["depth"])):
            t = t + delay_s
            if t >= horizon_s:
                break  # never processed, so it spawns no grandchildren
            j = len(times)
            times.append(t)
            victim.append(-1)
            parent.append(par)
            pred.append(bool(ev.predictable))
            during.append(False)
            causes.append("cascade")
            par = j

    n = len(times)
    t_arr = np.asarray(times, np.float64)
    v_arr = np.asarray(victim, np.int32)
    p_arr = np.asarray(parent, np.int32)
    pr_arr = np.asarray(pred, bool)
    du_arr = np.asarray(during, bool)
    if n > n0:  # cascade children were appended: merge-sort them in
        order = np.argsort(t_arr, kind="stable")
        inv = np.empty(n, np.int32)
        inv[order] = np.arange(n, dtype=np.int32)
        t_arr = t_arr[order]
        v_arr = v_arr[order]
        p_arr = np.where(p_arr[order] < 0, -1, inv[p_arr[order]]).astype(np.int32)
        pr_arr = pr_arr[order]
        du_arr = du_arr[order]
        causes = [causes[k] for k in order]

    # repair-delay draws, pre-sampled in the exact sequence the engine's
    # repair rng would emit (one draw per *scheduled* repair, consumed in
    # event-processing order — at most one per slot)
    if spec.repair_s is None:
        draws = np.zeros(n, np.float64)
    elif isinstance(spec.repair_s, (tuple, list)):
        rng = np.random.default_rng((base_seed, 0x5EED))
        draws = np.asarray([spec.sample_repair(rng) for _ in range(n)], np.float64)
    else:
        draws = np.full(n, float(spec.repair_s), np.float64)

    # statically resolve the partition component map active at each slot
    changes = spec.partition_timeline()
    part_active = np.zeros(n, bool)
    part_comp = np.full((n, H if changes else 1), -1, np.int32)
    if changes:
        cur: Optional[Dict[int, int]] = None
        ci = 0
        for k in range(n):
            while ci < len(changes) and changes[ci][0] <= t_arr[k]:
                cur = changes[ci][1]
                ci += 1
            if cur is not None:
                part_active[k] = True
                for h, c in cur.items():
                    if 0 <= h < H:
                        part_comp[k, h] = c

    return TrajectoryTape(
        spec_name=spec.name,
        seed=base_seed,
        n_hosts=H,
        times=t_arr,
        victim=v_arr,
        parent=p_arr,
        predictable=pr_arr,
        during_ckpt=du_arr,
        repair_draws=draws,
        causes=causes,
        rack_corr=np.asarray([c == "rack" for c in causes], bool),
        part_active=part_active,
        part_comp=part_comp,
        partition_changes=changes,
    )


@dataclass
class TapeBatch:
    """``n_seeds`` tapes, padded to a common slot count and stacked into
    structure-of-arrays form (the ``valid`` mask marks real slots)."""

    spec_name: str
    seeds: np.ndarray  # int64 [S]
    n_hosts: int
    times: np.ndarray  # float64 [S, n]
    victim: np.ndarray  # int32  [S, n]
    parent: np.ndarray  # int32  [S, n]
    predictable: np.ndarray  # bool [S, n]
    during_ckpt: np.ndarray  # bool [S, n]
    valid: np.ndarray  # bool [S, n]
    repair_draws: np.ndarray  # float64 [S, n]
    rack_corr: np.ndarray  # bool [S, n]
    part_active: np.ndarray  # bool [S, n]
    # [S, n, H] when the family has a partition timeline, [S, n, 1] (all
    # -1) otherwise — the fleet-scale memory term is gated, not implicit
    part_comp: np.ndarray  # int32 [S, n, H] or [S, n, 1]

    @property
    def n_seeds(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.times.shape[1])


def compile_batch(
    spec: ScenarioSpec, n_seeds: int, base_seed: int = 0
) -> TapeBatch:
    """Compile tapes for seeds ``base_seed .. base_seed + n_seeds - 1`` and
    pad/stack them (padding slots: ``t = +inf``, ``valid = False``). The
    slot count is rounded up to a multiple of 8 so the cached replay
    program is shared across batches whose max event count jitters."""
    tapes = [compile_tape(spec, base_seed + s) for s in range(n_seeds)]
    H = spec.n_nodes + spec.n_spares
    n = max(1, max(t.n_slots for t in tapes))
    n = -(-n // 8) * 8
    S = n_seeds

    times = np.full((S, n), np.inf, np.float64)
    victim = np.full((S, n), -1, np.int32)
    parent = np.full((S, n), -1, np.int32)
    pred = np.zeros((S, n), bool)
    during = np.zeros((S, n), bool)
    valid = np.zeros((S, n), bool)
    draws = np.zeros((S, n), np.float64)
    rcorr = np.zeros((S, n), bool)
    p_act = np.zeros((S, n), bool)
    # all tapes share the spec's (deterministic) partition timeline, so
    # their part_comp widths agree: H with cuts, 1 (compact) without
    W = max(tp.part_comp.shape[1] for tp in tapes)
    p_comp = np.full((S, n, W), -1, np.int32)
    for s, tp in enumerate(tapes):
        k = tp.n_slots
        times[s, :k] = tp.times
        victim[s, :k] = tp.victim
        parent[s, :k] = tp.parent
        pred[s, :k] = tp.predictable
        during[s, :k] = tp.during_ckpt
        valid[s, :k] = True
        draws[s, :k] = tp.repair_draws
        rcorr[s, :k] = tp.rack_corr
        p_act[s, :k] = tp.part_active
        p_comp[s, :k] = tp.part_comp

    return TapeBatch(
        spec_name=spec.name,
        seeds=np.arange(base_seed, base_seed + n_seeds, dtype=np.int64),
        n_hosts=H,
        times=times,
        victim=victim,
        parent=parent,
        predictable=pred,
        during_ckpt=during,
        valid=valid,
        repair_draws=draws,
        rack_corr=rcorr,
        part_active=p_act,
        part_comp=p_comp,
    )




# ======================================================================
# Layer 2: the batched replay fold
# ======================================================================
@dataclass(frozen=True)
class _ReplayStatic:
    """Hashable configuration of one replay program.

    The reference's ``donate`` flag (donating the tape's device buffers to
    the jitted program) has no torch counterpart: the fold stages the tape
    onto the device a tile at a time and frees each tile after its slots,
    so there is no whole-tape device buffer to donate."""

    n_hosts: int
    n_workers: int
    n_spares: int
    n_slots: int  # padded to a multiple of tile_slots
    period_s: float
    horizon_s: float
    max_strikes: int
    repair_none: bool
    # partition arrays reach the fold ONLY when the placement is
    # partition-aware AND the batch has an open cut on some slot
    # (otherwise the scope/quorum branches are provable no-ops)
    partition_aware: bool
    rules_agent_small: bool  # Rules 2-3 verdict for the (static) payload size
    # when True the fold additionally records per-slot decision arrays
    # (processed/handled/victim/target/...) for trace reconstruction
    record: bool = False
    # event-tape tiling: slots staged onto the device per transfer.
    # Padding slots are fully masked (valid=False), so totals are
    # bit-identical across tile sizes by construction.
    tile_slots: int = 8
    # seed-axis split over cards. Per-seed work is independent, so
    # results are bit-identical at any device count.
    n_devices: int = 1


@dataclass(frozen=True)
class _TableStatic:
    """The branch-selecting flags of a :class:`StrategyCostTable`. Only
    these choose the fold's Python branches — the numeric coefficients
    travel as a float64 tensor (``_COEFF_FIELDS`` order), so one cached
    program serves every cost table sharing this structure (e.g. all
    workloads' pricings of one strategy)."""

    mode: str  # "window" | "proactive" | "cold"
    mechanism: str  # "agent" | "core" | "rules"
    ckpt_invalidation: bool


#: host-axis width at or below which repair-completion ranking uses the
#: vectorised O(H^2) pairwise comparison matrix instead of a stable
#: argsort; at fleet widths (1k+ hosts) the O(H log H) sort is the only
#: affordable form. Both are bit-identical on the due hosts (the inverse
#: permutation of a stable sort restricted to finite keys equals the
#: pairwise earlier-or-tied-lower-index count).
_PAIRWISE_RANK_MAX_HOSTS = 128

#: the replay program's runtime ``coeffs`` argument (float64 [8])
_COEFF_FIELDS = (
    "probe_s_per_hour",
    "predict_s",
    "reinstate_s",
    "overhead_s",
    "agent_reinstate_s",
    "agent_overhead_s",
    "core_reinstate_s",
    "core_overhead_s",
)

#: tape fields staged onto the device tile by tile (slot-major on the host)
_SLOT_FIELDS = ("times", "victim", "parent", "pred", "verd", "during", "valid")


def _table_coeffs(table: StrategyCostTable) -> np.ndarray:
    return np.asarray([getattr(table, f) for f in _COEFF_FIELDS], np.float64)


def replay_cache_stats() -> Dict[str, int]:
    """Cache counters for the replay program. A sweep over N cost tables
    sharing one (scenario shape, table structure) should show N-1 hits,
    not N builds."""
    info = _compiled_replayer.cache_info()
    return {
        "hits": int(info.hits),
        "misses": int(info.misses),
        "programs": int(info.currsize),
    }


def _rank_due(ra: torch.Tensor, due: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Repair-completion rank of each due host among the due hosts:
    earlier completion first, equal times by host index. ``ra`` holds the
    due hosts' repair times and +inf elsewhere; ranks of hosts that are
    not due are not used."""
    H = ra.shape[1]
    if H <= _PAIRWISE_RANK_MAX_HOSTS:
        before = (ra[:, None, :] < ra[:, :, None]) | (
            (ra[:, None, :] == ra[:, :, None]) & (idx[None, :] < idx[:, None])
        )
        return (before & due[:, None, :]).sum(dim=2)
    order = torch.argsort(ra, dim=1, stable=True)
    return torch.zeros_like(order).scatter_(1, order, idx.expand_as(order))


@lru_cache(maxsize=128)
def _compiled_replayer(static: _ReplayStatic, tstatic: _TableStatic) -> Callable:
    """Build (and cache) the replay program for one (scenario-shape,
    cost-table-structure) pair. Cost-table *values* arrive as the runtime
    ``coeffs`` vector, so swapping strategies or workloads that share
    structure reuses the program.

    The program's signature is ``fn(coeffs, tape, device)``: ``coeffs``
    the float64 [8] ``_COEFF_FIELDS`` vector, ``tape`` a dict of numpy
    ``[S, ...]`` slot arrays, ``device`` the first card of the seed split
    (or the CPU). It returns the reference's output dict, as numpy."""
    H = static.n_hosts
    n_slots = static.n_slots
    tile = static.tile_slots
    period_s = static.period_s
    horizon_s = static.horizon_s
    max_strikes = static.max_strikes
    mode = tstatic.mode

    # initial dependency degrees of the engine's star topology (genome
    # search: workers feed one combiner, spares carry no edges)
    deg0 = np.zeros(H, np.int32)
    if static.n_workers > 1:
        deg0[: static.n_workers - 1] = 1
        deg0[static.n_workers - 1] = static.n_workers - 1

    def fold(coeffs: np.ndarray, tape: Dict[str, np.ndarray], dev: torch.device):
        """Every seed of ``tape`` through every slot, on ``dev``."""
        S = tape["times"].shape[0]
        f64, i32, i64 = torch.float64, torch.int32, torch.int64

        def const(x, dtype=f64):
            return torch.tensor(x, dtype=dtype, device=dev)

        cf = torch.as_tensor(coeffs, dtype=f64).to(dev)
        c_probe, c_predict, c_reinstate, c_overhead = cf[0], cf[1], cf[2], cf[3]
        c_agent_rst, c_agent_ovh, c_core_rst, c_core_ovh = cf[4], cf[5], cf[6], cf[7]
        zero, inf, nan = const(0.0), const(np.inf), const(np.nan)
        period, horizon, hour = const(period_s), const(horizon_s), const(3600.0)
        ckpt_factor = (const(1.5), const(1.0))
        true = const(True, torch.bool)
        minus1 = const(-1, i64)
        idx = torch.arange(H, dtype=i64, device=dev)
        idx_row = idx[None, :]

        # the tape on the device: the slot fields tile by tile from a
        # slot-major host copy (pinned on the card), the repair draws whole
        # (indexed by each seed's repair count)
        pinned = dev.type == "cuda"
        names = _SLOT_FIELDS + (("pa", "comp") if static.partition_aware else ())
        host = {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(tape[k], 0, 1)))
                for k in names}
        if static.partition_aware:
            host["comp"] = host["comp"].to(i64)  # a gather index
        if pinned:
            host = {k: v.pin_memory() for k, v in host.items()}
        draws = torch.from_numpy(np.ascontiguousarray(tape["draws"])).to(dev)

        # -- state (the reference's init, seeds on the first axis)
        down = torch.zeros((S, H), dtype=torch.bool, device=dev)
        repair_at = torch.full((S, H), np.inf, dtype=f64, device=dev)
        black = torch.zeros((S, H), dtype=torch.bool, device=dev)
        strikes = torch.zeros((S, H), dtype=i32, device=dev)
        occupied = (idx_row < static.n_workers).expand(S, H).clone()
        spare_seq = torch.where(
            idx_row >= static.n_workers, (idx_row - static.n_workers).to(f64), inf
        ).expand(S, H).clone()
        next_seq = torch.full((S,), float(static.n_spares), dtype=f64, device=dev)
        deg = torch.as_tensor(deg0).to(dev)[None, :].expand(S, H).clone()
        attempt = torch.zeros((S, H), dtype=f64, device=dev)
        rcount = torch.zeros((S,), dtype=i64, device=dev)
        n_events = torch.zeros((S,), dtype=i32, device=dev)
        n_handled = torch.zeros((S,), dtype=i32, device=dev)
        n_migrations = torch.zeros((S,), dtype=i32, device=dev)
        n_blacklisted = torch.zeros((S,), dtype=i32, device=dev)
        n_reprovisioned = torch.zeros((S,), dtype=i32, device=dev)
        lost = torch.zeros((S,), dtype=f64, device=dev)
        reinstate = torch.zeros((S,), dtype=f64, device=dev)
        overhead = torch.zeros((S,), dtype=f64, device=dev)
        alive = torch.ones((S,), dtype=torch.bool, device=dev)
        failed_at = torch.zeros((S,), dtype=f64, device=dev)
        fired = torch.zeros((S, n_slots), dtype=torch.bool, device=dev)
        tgt_rec = torch.full((S, n_slots), -1, dtype=i64, device=dev)
        rec = None
        if static.record:
            rec = {
                "processed": torch.zeros((S, n_slots), dtype=torch.bool, device=dev),
                "handled": torch.zeros((S, n_slots), dtype=torch.bool, device=dev),
                "victim": torch.full((S, n_slots), -1, dtype=i32, device=dev),
                "target": torch.full((S, n_slots), -1, dtype=i32, device=dev),
                "blacklisted": torch.zeros((S, n_slots), dtype=torch.bool, device=dev),
                "repair_sched": torch.zeros((S, n_slots), dtype=torch.bool, device=dev),
                "repair_at": torch.full((S, n_slots), np.inf, dtype=f64, device=dev),
                "stranded": torch.zeros((S, n_slots), dtype=torch.bool, device=dev),
            }

        for a in range(0, n_slots, tile):
            xs = {k: v[a : a + tile].to(dev, non_blocking=pinned) for k, v in host.items()}
            for k in range(tile):
                j = a + k
                t = xs["times"][k]
                t_col = t[:, None]
                live = xs["valid"][k] & alive

                # -- repairs completing strictly before t rejoin the spare
                #    pool in completion order (heap: repair events pushed
                #    after the original stream pop later at equal times)
                due = live[:, None] & (repair_at < t_col)
                ra = torch.where(due, repair_at, inf)
                rank = _rank_due(ra, due, idx)
                nrep = due.sum(dim=1)
                spare_seq = torch.where(due, next_seq[:, None] + rank.to(f64), spare_seq)
                next_seq = next_seq + nrep.to(f64)
                down = down & ~due
                repair_at = torch.where(due, inf, repair_at)
                n_reprovisioned = n_reprovisioned + nrep.to(i32)

                # -- resolve the victim: cascade children chase the host
                #    their parent's sub-job migrated to, and only exist if
                #    it did
                par = xs["parent"][k].to(i64)
                has_par = par >= 0
                pi = par.clamp(min=0)[:, None]
                victim = torch.where(has_par, tgt_rec.gather(1, pi)[:, 0], xs["victim"][k].to(i64))
                spawned = torch.where(has_par, fired.gather(1, pi)[:, 0], true)
                active = live & spawned & (victim >= 0)
                v = victim.clamp(0, H - 1)[:, None]
                n_events = n_events + active.to(i32)
                processed = active & ~down.gather(1, v)[:, 0]

                strikes.scatter_add_(1, v, processed.to(i32)[:, None])
                if static.repair_none:
                    permanent = processed
                else:
                    permanent = processed & (strikes.gather(1, v)[:, 0] >= max_strikes)
                has_work = occupied.gather(1, v)[:, 0]

                # -- placement: nearest-spare with require_free (pool FIFO
                #    -> ring neighbours -> first free host), partition-
                #    scoped and quorum-gated when the campaign runs
                #    partition-aware
                okf = ~black & ~down & ~occupied
                if static.partition_aware:
                    pa = xs["pa"][k]
                    comp = xs["comp"][k]
                    allowed = torch.where(pa[:, None], comp == comp.gather(1, v), true)
                    okf = okf & allowed
                pool = torch.isfinite(spare_seq) & okf
                i1 = torch.argmin(torch.where(pool, spare_seq, inf), dim=1)
                nb1 = (v - 1) % H
                nb2 = (v + 1) % H
                m3 = okf & (idx_row != v)
                first_free = torch.argmax(m3.to(i32), dim=1)
                target = torch.where(
                    pool.any(dim=1),
                    i1,
                    torch.where(
                        okf.gather(1, nb1)[:, 0],
                        nb1[:, 0],
                        torch.where(
                            okf.gather(1, nb2)[:, 0],
                            nb2[:, 0],
                            torch.where(m3.any(dim=1), first_free, minus1),
                        ),
                    ),
                )
                if static.partition_aware:
                    members = (~down & allowed).sum(dim=1)
                    n_alive = (~down).sum(dim=1)
                    target = torch.where(pa & (2 * members <= n_alive), minus1, target)
                target = torch.where(processed & has_work, target, minus1)

                stranded = processed & has_work & (target < 0)
                handled = processed & has_work & (target >= 0)
                tgt = target.clamp(0, H - 1)[:, None]

                # -- per-event billing from the StrategyCostTable
                wstart = torch.floor(t / period) * period
                if mode == "window":
                    if tstatic.ckpt_invalidation:
                        # mid-checkpoint failure: restore from one window
                        # back plus the wasted partial write
                        dur = xs["during"][k]
                        lost_ev = (t - wstart) + torch.where(dur, period, zero)
                        ovh_ev = c_overhead * torch.where(dur, *ckpt_factor)
                    else:
                        lost_ev = t - wstart
                        ovh_ev = c_overhead
                    rst_ev = c_reinstate
                elif mode == "proactive":
                    vrd = xs["verd"][k]
                    if tstatic.mechanism == "agent":
                        rst_m, ovh_ev = c_agent_rst, c_agent_ovh
                    elif tstatic.mechanism == "rules" and static.rules_agent_small:
                        # Z-negotiation per event (Rules 1-3)
                        is_agent = deg.gather(1, v)[:, 0] > Z_THRESHOLD
                        rst_m = torch.where(is_agent, c_agent_rst, c_core_rst)
                        ovh_ev = torch.where(is_agent, c_agent_ovh, c_core_ovh)
                    else:  # "core", or "rules" with a large payload
                        rst_m, ovh_ev = c_core_rst, c_core_ovh
                    # a failure is only *saved* when the detector claimed
                    # it AND a real lead window existed (ground-truth
                    # signature); every claim — true or false — pays the
                    # prediction work
                    lost_ev = torch.where(vrd & xs["pred"][k], zero, t - wstart)
                    rst_ev = rst_m + torch.where(vrd, c_predict, zero)
                else:  # "cold": lose everything since the sub-job's last start
                    lost_ev = t - attempt.gather(1, v)[:, 0]
                    rst_ev = c_reinstate
                    ovh_ev = zero

                lost = lost + torch.where(handled, lost_ev, zero)
                reinstate = reinstate + torch.where(handled, rst_ev, zero)
                overhead = overhead + torch.where(handled, ovh_ev, zero)
                n_handled = n_handled + handled.to(i32)
                if mode == "proactive":
                    n_migrations = n_migrations + handled.to(i32)

                # -- migrate the sub-job (occupancy, pool, dependency
                #    degree, cold attempt clock follow the work)
                h_col = handled[:, None]
                occupied.scatter_(1, v, occupied.gather(1, v) & ~h_col)
                occupied.scatter_(1, tgt, occupied.gather(1, tgt) | h_col)
                spare_seq.scatter_(
                    1, tgt, torch.where(h_col, inf, spare_seq.gather(1, tgt))
                )
                degv = deg.gather(1, v)
                deg.scatter_(1, tgt, torch.where(h_col, degv, deg.gather(1, tgt)))
                deg.scatter_(1, v, torch.where(h_col, 0, deg.gather(1, v)))
                if mode == "cold":
                    attempt.scatter_(
                        1, tgt, torch.where(h_col, t_col, attempt.gather(1, tgt))
                    )

                # -- fail the victim; blacklist or schedule its repair
                p_col = processed[:, None]
                down.scatter_(1, v, down.gather(1, v) | p_col)
                spare_seq.scatter_(
                    1, v, torch.where(p_col, inf, spare_seq.gather(1, v))
                )
                newly_black = permanent & ~stranded
                black.scatter_(1, v, black.gather(1, v) | newly_black[:, None])
                n_blacklisted = n_blacklisted + newly_black.to(i32)
                sched = processed & ~stranded & ~permanent
                rdraw = draws.gather(1, rcount.clamp(0, n_slots - 1)[:, None])[:, 0]
                repair_t = t + rdraw
                repair_at.scatter_(
                    1, v, torch.where(sched[:, None], repair_t[:, None], repair_at.gather(1, v))
                )
                rcount = rcount + sched.to(i64)

                alive = alive & ~stranded
                failed_at = torch.where(stranded, t, failed_at)
                fired[:, j] = handled
                tgt_rec[:, j] = torch.where(handled, tgt[:, 0], minus1)

                # per-slot decision record for trace reconstruction:
                # exactly the facts the engine's emit sites see
                if rec is not None:
                    rec["processed"][:, j] = processed
                    rec["handled"][:, j] = handled
                    rec["victim"][:, j] = torch.where(processed, v[:, 0], minus1)
                    rec["target"][:, j] = torch.where(handled, tgt[:, 0], minus1)
                    rec["blacklisted"][:, j] = newly_black
                    rec["repair_sched"][:, j] = sched
                    rec["repair_at"][:, j] = torch.where(sched, repair_t, inf)
                    rec["stranded"][:, j] = stranded

        # repairs still pending at the end of the stream complete (and are
        # counted) if they land inside the horizon — unless the campaign
        # was lost, in which case the engine abandons the queue
        tail_repairs = (repair_at < horizon).sum(dim=1).to(i32)
        n_reprovisioned = n_reprovisioned + torch.where(alive, tail_repairs, 0)

        # background probing accrues only while the campaign is running
        span_s = torch.where(alive, horizon, failed_at)
        probe = c_probe * span_s / hour
        total = torch.where(alive, horizon + lost + reinstate + overhead + probe, nan)
        out = dict(
            survived=alive,
            total_s=total,
            failed_at_s=torch.where(alive, nan, failed_at),
            lost_s=lost,
            reinstate_s=reinstate,
            overhead_s=overhead,
            probe_s=probe,
            n_events=n_events,
            n_handled=n_handled,
            n_migrations=n_migrations,
            n_blacklisted=n_blacklisted,
            n_reprovisioned=n_reprovisioned,
        )
        if rec is not None:
            out.update({"slot_" + k: v for k, v in rec.items()})
        return out

    def program(coeffs: np.ndarray, tape: Dict[str, np.ndarray], device) -> Dict[str, np.ndarray]:
        dev = torch.device(device)
        n = static.n_devices
        S = tape["times"].shape[0]
        if dev.type == "cuda":
            base = 0 if dev.index is None else dev.index
            devs = [torch.device("cuda", base + i) for i in range(n)]
        else:
            devs = [dev] * n  # the CPU runs the chunks in turn
        per = S // n
        parts = [
            fold(coeffs, {k: v[i * per : (i + 1) * per] for k, v in tape.items()}, d)
            for i, d in enumerate(devs)
        ]
        # every chunk's launches are queued before the first result is read
        return {
            k: np.concatenate([p[k].cpu().numpy() for p in parts]) for k in parts[0]
        }

    return program


def _payload_bytes(payload_elems: int) -> int:
    """S_d of the engine's per-host sub-job payload (Rules 2-3 input)."""
    # engine fidelity: the real sub-job payload ships f32 partials
    return tree_bytes({"partial": np.zeros(payload_elems, np.float32), "cursor": 0})  # repro: ignore[dtype-x64]


def _default_micro(workload, profile: str, n_nodes: int):
    """Default MicroCosts per (workload, profile, n_nodes). The
    underlying ``measure_micro`` is memoized on its full argument tuple,
    so repeated replay_batch/mc_trajectories calls under the same
    workload share one record — and therefore one cached program."""
    return workload.micro(profile, n_nodes=n_nodes)


def default_seed_devices(n_seeds: int) -> int:
    """The default seed split for :func:`replay_batch`: one device.

    The reference splits inside one ``shard_map`` program; here each card's
    chunk is issued in turn from one host thread, and the fold is bound by
    its launches, so a split multiplies the launches and buys memory, not
    time. A caller that needs the memory passes ``n_devices``. Splitting
    never changes results (per-seed work is independent), only placement."""
    return 1


def _resolve_program(
    spec: ScenarioSpec,
    batch: TapeBatch,
    strategy,
    *,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    payload_elems: int = 1 << 10,
    detector="oracle",
    workload=None,
    record_slots: bool = False,
    tile_slots: int = 8,
    n_devices: Optional[int] = None,
    device="cuda",
):
    """Shared front half of the replay path: resolve strategy / detector /
    workload micro, pre-sample per-seed verdict tapes, pad the slot axis
    to the tile multiple, build (or fetch from cache) the replay program.
    Returns ``(fn, args, detector, verdicts, ctx)`` with ``args = (coeffs,
    tape)`` and ``ctx`` the resolved billing inputs (strategy cost table,
    ``rules_agent_small``); ``fn(*args)`` runs the fold on ``device``."""
    from repro_torch.telemetry import resolve as resolve_detector
    from repro_torch.workloads import resolve as resolve_workload

    dev = resolve_device(device)
    if isinstance(strategy, FaultToleranceStrategy):
        strat = strategy
    else:
        strat = strategy_registry.get(strategy)
    det = resolve_detector(detector, dev)
    if micro is None:
        micro = _default_micro(resolve_workload(workload, spec, device=dev), profile, spec.n_nodes)
    table = strat.cost_table(CostContext(micro=micro, period_h=spec.period_s / 3600.0))

    # per-seed verdict tapes (the oracle's is the predictable bits verbatim)
    verdicts = np.zeros_like(batch.predictable)
    for s in range(batch.n_seeds):
        v, _ = det.verdict_tape(
            spec,
            times=batch.times[s],
            predictable=batch.predictable[s],
            rack_corr=batch.rack_corr[s],
            seed=int(batch.seeds[s]),
        )
        verdicts[s] = v

    placement = placement or spec.placement or "nearest-spare"
    if placement not in ("nearest-spare", "partition-aware"):
        raise ValueError(
            f"replay fold supports 'nearest-spare' / 'partition-aware' "
            f"placement, not {placement!r}; run through CampaignEngine instead"
        )

    # pad the slot axis to a multiple of the tile size. Padding slots are
    # fully masked (valid=False => every state update under them is a
    # no-op), so totals are bit-identical across tile sizes.
    tile = max(1, int(tile_slots))
    n_slots = -(-batch.n_slots // tile) * tile
    pad = n_slots - batch.n_slots

    def padded(a: np.ndarray, fill) -> np.ndarray:
        if pad == 0:
            return a
        out = np.full((a.shape[0], n_slots) + a.shape[2:], fill, a.dtype)
        out[:, : batch.n_slots] = a
        return out

    tape = dict(
        times=padded(batch.times, np.inf),
        victim=padded(batch.victim, -1),
        parent=padded(batch.parent, -1),
        pred=padded(batch.predictable, False),
        verd=padded(verdicts, False),
        during=padded(batch.during_ckpt, False),
        valid=padded(batch.valid, False),
        draws=padded(batch.repair_draws, 0.0),
    )
    # the O(n_slots x H) component tape only ships when the placement can
    # consume it AND a cut is actually open somewhere in the batch
    use_partition = placement == "partition-aware" and bool(batch.part_active.any())
    if use_partition:
        if batch.part_comp.shape[2] != batch.n_hosts:
            raise ValueError(
                "batch has active partition slots but a compacted part_comp "
                f"tape (width {batch.part_comp.shape[2]} != {batch.n_hosts})"
            )
        tape["pa"] = padded(batch.part_active, False)
        tape["comp"] = padded(batch.part_comp, -1)

    if n_devices is None:
        n_devices = default_seed_devices(batch.n_seeds)
    n_devices = max(1, int(n_devices))
    if dev.type == "cuda":
        first = 0 if dev.index is None else dev.index
        if first + n_devices > torch.cuda.device_count():
            raise ValueError(
                f"n_devices={n_devices} from {dev} > available CUDA devices "
                f"({torch.cuda.device_count()})"
            )
    if batch.n_seeds % n_devices:
        raise ValueError(
            f"n_devices={n_devices} must divide the seed axis ({batch.n_seeds})"
        )

    static = _ReplayStatic(
        n_hosts=batch.n_hosts,
        n_workers=spec.n_nodes,
        n_spares=spec.n_spares,
        n_slots=n_slots,
        period_s=float(spec.period_s),
        horizon_s=float(spec.horizon_s),
        max_strikes=int(spec.max_strikes),
        repair_none=spec.repair_s is None,
        partition_aware=use_partition,
        rules_agent_small=_payload_bytes(payload_elems) <= SD_THRESHOLD_BYTES,
        record=record_slots,
        tile_slots=tile,
        n_devices=n_devices,
    )
    tstatic = _TableStatic(
        mode=table.mode,
        mechanism=table.mechanism,
        ckpt_invalidation=bool(table.ckpt_invalidation),
    )
    fn = partial(_compiled_replayer(static, tstatic), device=dev)
    args = (_table_coeffs(table), tape)
    ctx = {"table": table, "rules_agent_small": static.rules_agent_small}
    return fn, args, det, verdicts, ctx


def replay_program(
    spec: ScenarioSpec,
    batch: TapeBatch,
    strategy,
    *,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    payload_elems: int = 1 << 10,
    detector="oracle",
    workload=None,
    record_slots: bool = False,
    tile_slots: int = 8,
    n_devices: Optional[int] = None,
    device="cuda",
) -> Tuple:
    """The profilable handle on the replay fold: ``(fn, args)``.

    ``fn`` is the cached program bound to ``device`` and ``args`` the
    exact ``(coeffs, tape)`` pair :func:`replay_batch` would feed it;
    ``fn(*args)`` returns the fold's raw per-seed outputs as numpy (before
    the degrade slowdown is added)."""
    fn, args, _, _, _ = _resolve_program(
        spec,
        batch,
        strategy,
        micro=micro,
        profile=profile,
        placement=placement,
        payload_elems=payload_elems,
        detector=detector,
        workload=workload,
        record_slots=record_slots,
        tile_slots=tile_slots,
        n_devices=n_devices,
        device=device,
    )
    return fn, args


def replay_batch(
    spec: ScenarioSpec,
    batch: TapeBatch,
    strategy,
    *,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    payload_elems: int = 1 << 10,
    detector="oracle",
    workload=None,
    autoscaler=None,
    record_slots: bool = False,
    tile_slots: int = 8,
    n_devices: Optional[int] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Replay a compiled :class:`TapeBatch` under one strategy's cost table.

    ``strategy`` is a registered name (aliases ok) or a strategy
    instance; ``detector`` likewise (a :class:`~repro_torch.telemetry.
    detector.Detector` name or instance); ``workload`` a
    :mod:`repro_torch.workloads` name or instance supplying the micro-costs
    when none are given (default: the spec's declared workload, then
    ``analytic`` — the seed cost model bit-for-bit). Because the engine
    resolves the identical record, trial-for-trial parity holds under
    every workload. Per-event verdict tapes are pre-sampled per seed in
    schedule order — the exact draws the Python engine makes — and fed to
    the fold alongside the ground-truth ``predictable`` bits (a failure
    is *saved* only when claimed AND a real lead window existed; every
    claim pays the prediction work), so the replay stays trial-for-trial
    identical to ``CampaignEngine(spec, strategy, seed=k, detector=...)``
    under any detector. Returns per-seed numpy arrays keyed like
    :class:`~repro_torch.scenarios.engine.CampaignResult` fields
    (``total_s`` / ``failed_at_s`` are NaN where inapplicable).

    The fold runs on ``device`` (the card unless the caller asks for the
    CPU); without a card a CUDA device raises, it never falls back.

    ``record_slots=True`` additionally returns per-slot decision arrays
    (``slot_processed`` / ``slot_handled`` / ``slot_victim`` /
    ``slot_target`` / ``slot_blacklisted`` / ``slot_repair_sched`` /
    ``slot_repair_at`` / ``slot_stranded``, each ``[S, n_slots]``) plus
    the pre-sampled ``slot_verdict`` tape.

    ``tile_slots`` sets how many slots of the tape are staged onto the
    device at a time (the slot axis is padded to a multiple) and
    ``n_devices`` the number of cards the seed axis is split over
    (default 1, see :func:`default_seed_devices`; on the CPU any count
    runs its chunks in turn). Both are pure execution-shape knobs: results
    are bit-identical across every tile size and device count.

    A spec that declares traffic is also billed for request-level SLOs
    (``slo_p50_s`` / ``slo_p99_s`` / ``slo_dropped`` /
    ``slo_availability``, one float64 per seed) under ``autoscaler`` (a
    :mod:`repro_torch.traffic` name or instance; None for the traffic
    spec's default), by the same host function and on the same inputs as
    :class:`~repro_torch.scenarios.engine.CampaignEngine`: each seed's
    valid-prefix slice of the host tape and its verdict tape, so the four
    numbers equal the engine's bit for bit."""
    from repro_torch.scenarios.spec import degrade_slowdown_s

    fn, args, det, verdicts, ctx = _resolve_program(
        spec,
        batch,
        strategy,
        micro=micro,
        profile=profile,
        placement=placement,
        payload_elems=payload_elems,
        detector=detector,
        workload=workload,
        record_slots=record_slots,
        tile_slots=tile_slots,
        n_devices=n_devices,
        device=device,
    )
    out = fn(*args)
    if record_slots:
        # drop the tile-padding slots so per-slot arrays keep the batch's
        # slot-axis contract (padding rows are all-masked no-ops anyway)
        for k in list(out):
            if k.startswith("slot_"):
                out[k] = out[k][:, : batch.n_slots]

    # degrade windows bill identically to the engine: a deterministic
    # extra-step-time scalar per campaign (NaN totals stay NaN)
    slow = degrade_slowdown_s(spec, mitigate_stragglers=det.flags_stragglers)
    if slow:
        out["total_s"] = out["total_s"] + slow
    out["slowdown_s"] = np.full(batch.n_seeds, slow, np.float64)

    # request-level SLO billing: the identical shared deterministic
    # function (and identical inputs — valid-prefix tape slices + the
    # per-seed verdict tapes, host numpy) the engine calls, so the four
    # SLO arrays are trial-for-trial bitwise equal to CampaignEngine's fields
    if getattr(spec, "traffic", None) is not None:
        from repro_torch.traffic.slo import bill_slo
        from repro_torch.workloads import resolve as resolve_workload

        wtable = resolve_workload(workload, spec, device=device).cost_table(
            profile, n_nodes=spec.n_nodes
        )
        S = batch.n_seeds
        slo = {
            "slo_p50_s": np.empty(S, np.float64),
            "slo_p99_s": np.empty(S, np.float64),
            "slo_dropped": np.empty(S, np.float64),
            "slo_availability": np.empty(S, np.float64),
        }
        for s in range(S):
            m = batch.valid[s]
            bill = bill_slo(
                spec,
                times=batch.times[s][m],
                victim=batch.victim[s][m],
                parent=batch.parent[s][m],
                predictable=batch.predictable[s][m],
                verdicts=verdicts[s][m],
                draws=batch.repair_draws[s][m],
                table=ctx["table"],
                wtable=wtable,
                seed=int(batch.seeds[s]),
                autoscaler=autoscaler,
                rules_agent_small=ctx["rules_agent_small"],
            )
            slo["slo_p50_s"][s] = bill.p50_s
            slo["slo_p99_s"][s] = bill.p99_s
            slo["slo_dropped"][s] = bill.dropped
            slo["slo_availability"][s] = bill.availability
        out.update(slo)

    if record_slots:
        out["slot_verdict"] = verdicts
    return out
