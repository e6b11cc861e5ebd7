"""Profiling hooks: one wall-clock timing idiom for the whole port.

The counterpart of ``repro/obs/profile.py``. Every measured number the
port reports — calibrated workload surfaces, replay throughput, the
measured kernel step surfaces — goes through this module:

:func:`stopwatch` / :func:`now_s`
    the primitive perf-counter pair as a context manager
    (``utils.timing`` re-exports these);
:func:`timed`
    measure a callable properly: warmup iterations first (program caches
    fill, kernels build), ``torch.cuda.synchronize`` on the device of
    every CUDA tensor in the result after every timed iteration (PyTorch
    returns before the card finishes, so without it a timing measures the
    launch alone), and a :class:`Timed` record with mean/min/total;
:func:`profile_replay`
    the torch replay fold's build-vs-execute split, its peak device
    memory and the headline seeds/sec throughput metric;
:func:`time_kernel` / :func:`kernel_step_surface`
    measured per-shard-count step-time surfaces for the CUDA attention
    kernels in ``kernels/`` — the *measured* counterpart of the analytic
    surfaces in ``workloads/builtin.py``. A CUDA tensor runs the
    hand-written kernel (never the plain version); a CPU tensor runs the
    plain version. ``backend`` (the tensors' device type) and ``impl``
    (``"kernel"`` only when the launch counters show the CUDA kernel ran)
    travel with every number, so a CPU figure is never mistaken for a
    card's.

Pass ``trace_dir=`` to :func:`profile_replay` to additionally export a
``torch.profiler`` chrome trace of the execute phase (viewable in
Perfetto); the hook is inert by default.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


def now_s() -> float:
    """The port's one wall-clock: ``time.perf_counter()``."""
    return time.perf_counter()


class _Elapsed:
    """Mutable elapsed-seconds cell filled when a stopwatch block exits."""

    __slots__ = ("s",)

    def __init__(self):
        self.s = 0.0


@contextmanager
def stopwatch():
    """``with stopwatch() as sw: ... ; use sw.s`` — the perf-counter pair."""
    sw = _Elapsed()
    t0 = time.perf_counter()
    try:
        yield sw
    finally:
        sw.s = time.perf_counter() - t0


@dataclass
class Timed:
    """One properly-measured callable: warmed up, synchronised, repeated."""

    name: str
    n: int
    warmup: int
    times_s: List[float] = field(default_factory=list)
    result: object = None  # last iteration's (synchronised) return value

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s) if self.times_s else 0.0

    @property
    def min_s(self) -> float:
        return min(self.times_s) if self.times_s else 0.0

    @property
    def total_s(self) -> float:
        return sum(self.times_s)

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "n": self.n,
            "warmup": self.warmup,
            "mean_s": self.mean_s,
            "min_s": self.min_s,
        }


def _block(x):
    """Wait for the card's work on every CUDA tensor in ``x`` (a tensor or
    a tree of them; anything else passes through untouched)."""
    import torch

    from repro_torch.utils.tree import flatten

    devices = {leaf.device for leaf in flatten(x)[0]
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


def timed(
    fn: Callable,
    *args,
    n: int = 3,
    warmup: int = 1,
    block: bool = True,
    name: Optional[str] = None,
    **kwargs,
) -> Timed:
    """Measure ``fn(*args, **kwargs)``: ``warmup`` unrecorded calls (kernel
    builds, program caches), then ``n`` timed calls, each synchronised on
    the device of the result's CUDA tensors when ``block``."""
    out = Timed(name=name or getattr(fn, "__name__", "fn"), n=n, warmup=warmup)
    for _ in range(warmup):
        r = fn(*args, **kwargs)
        if block:
            _block(r)
    for _ in range(n):
        with stopwatch() as sw:
            r = fn(*args, **kwargs)
            if block:
                r = _block(r)
        out.times_s.append(sw.s)
        out.result = r
    return out


# ======================================================================
# The replay fold: build-vs-execute split + seeds/sec
# ======================================================================
def profile_replay(
    spec,
    strategy,
    n_seeds: int = 256,
    *,
    micro=None,
    profile: str = "placentia",
    placement: Optional[str] = None,
    detector="oracle",
    workload=None,
    n_exec: int = 3,
    trace_dir: Optional[str] = None,
    tile_slots: int = 8,
    n_devices: Optional[int] = None,
    record_slots: bool = False,
    device="cuda",
) -> Dict:
    """Profile one family × strategy through the batched replay fold.

    Splits the wall-clock into the phases that matter for scaling:

    ``tape_compile_s``   the Python trajectory compiler (per-seed tapes)
    ``build_s``          the program's build: verdict tapes, padding and
                         the cached fold (the reference's XLA
                         ``lower_s``/``compile_s`` have no counterpart:
                         the fold runs eagerly)
    ``execute_s``        steady-state execution (mean of ``n_exec`` runs;
                         the fold returns host numpy, so each run has
                         ended on the device when its clock is read) —
                         and ``seeds_per_s`` derived from it

    ``tile_slots`` / ``n_devices`` profile the tile/split execution shape
    (results are bit-identical across both; only the cost moves).
    ``memory`` carries the peak device bytes of the warm-up run
    (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``; None on the CPU). The reference's
    ``donate`` has no counterpart (the fold stages the tape a tile at a
    time). ``trace_dir`` wraps the execute phase in ``torch.profiler`` and
    writes ``replay_trace.json`` there (a chrome trace)."""
    import torch

    from repro_torch.scenarios.trajectory import compile_batch, replay_program
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with stopwatch() as sw_tape:
        batch = compile_batch(spec, n_seeds)
    with stopwatch() as sw_build:
        fn, args = replay_program(
            spec,
            batch,
            strategy,
            micro=micro,
            profile=profile,
            placement=placement,
            detector=detector,
            workload=workload,
            tile_slots=tile_slots,
            n_devices=n_devices,
            record_slots=record_slots,
            device=dev,
        )
    memory = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)  # warm-up: first run pays the pinned staging buffers
    if dev.type == "cuda":
        memory = {"peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    if trace_dir is None:
        t_exec = timed(fn, *args, n=n_exec, warmup=0, name="replay_exec")
    else:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch_profile(activities=activities) as prof:
            t_exec = timed(fn, *args, n=n_exec, warmup=0, name="replay_exec")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "replay_trace.json"))
    exec_s = t_exec.mean_s
    return {
        "family": spec.name,
        "strategy": getattr(strategy, "name", str(strategy)),
        "n_seeds": int(n_seeds),
        "n_slots": int(batch.n_slots),
        "backend": dev.type,
        "n_devices": int(n_devices or 1),
        "tile_slots": int(tile_slots),
        "tape_compile_s": round(sw_tape.s, 5),
        "build_s": round(sw_build.s, 5),
        "execute_s": round(exec_s, 6),
        "seeds_per_s": round(n_seeds / max(exec_s, 1e-9), 1),
        "compile_over_execute": round(sw_build.s / max(exec_s, 1e-9), 1),
        "memory": memory,
        "trace_dir": trace_dir,
    }


# ======================================================================
# CUDA attention kernels: measured per-shard-count step surfaces
# ======================================================================
def _normal(rng, shape, device):
    """Standard normals drawn with numpy (as the reference draws them),
    as a float32 tensor on ``device``."""
    import torch

    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)


def _decode_case(batch: int, seq_len: int, heads: int, head_dim: int, device) -> Callable:
    """One decode step over a full cache: the reference's ``_decode_case``
    (seed 0, float32, heads = KV heads, every slot valid, ``pos = seq_len -
    1``) through ``ops.flash_decode``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    q = _normal(rng, (batch, heads, head_dim), device)
    k = _normal(rng, (batch, heads, seq_len, head_dim), device)
    v = _normal(rng, (batch, heads, seq_len, head_dim), device)
    kpos = torch.arange(seq_len, dtype=torch.int32, device=device).repeat(batch, 1)
    pos = seq_len - 1  # scalar decode position (the cache is full)
    return lambda: ops.flash_decode(q, k, v, kpos, pos)


def _attention_case(batch: int, seq_len: int, heads: int, head_dim: int, device) -> Callable:
    """Causal prefill attention: the reference's ``_attention_case`` (seed
    0, float32, (batch, heads, seq_len, head_dim) for q, k and v) through
    ``ops.flash_attention``."""
    import numpy as np

    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    shape = (batch, heads, seq_len, head_dim)
    q = _normal(rng, shape, device)
    k = _normal(rng, shape, device)
    v = _normal(rng, shape, device)
    return lambda: ops.flash_attention(q, k, v, causal=True)


#: kernel name -> (builder(batch, seq_len, heads, head_dim, device) returning
#: the call to time, the ``ops.launch_counts`` key of its CUDA kernel)
_KERNEL_CASES = {
    "decode_attention": (_decode_case, "flash_decode"),
    "flash_attention": (_attention_case, "flash_attention"),
}


def time_kernel(
    kernel: str,
    *,
    n_shards: Sequence[int] = (1, 2, 4),
    batch: int = 8,
    seq_len: int = 256,
    heads: int = 4,
    head_dim: int = 64,
    n: int = 2,
    warmup: int = 1,
    device="cuda",
) -> Dict:
    """Time one ``kernels/`` entry point per shard count (the counterpart
    of the reference's ``time_pallas_kernel``).

    Sharding splits the batch (decode: the per-shard cache slice stays
    whole — each shard serves ``batch / n`` sessions), so the measured
    curve is the per-shard step time a fleet of ``n`` would see. On the
    card each call launches the CUDA kernel (a kernel that cannot build or
    launch raises); on the CPU the plain version runs. ``backend`` and
    ``impl`` travel with the numbers, and ``launches`` counts the CUDA
    kernel's launches of this call (``len(n_shards) * (warmup + n)`` on the
    card, 0 on the CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.utils.device import resolve_device

    if kernel not in _KERNEL_CASES:
        raise ValueError(f"unknown kernel {kernel!r}; one of {tuple(_KERNEL_CASES)}")
    dev = resolve_device(device)
    build, counter = _KERNEL_CASES[kernel]
    before = ops.launch_counts()[counter]
    times = []
    for ns in n_shards:
        b = max(batch // int(ns), 1)
        fn = build(b, seq_len, heads, head_dim, dev)
        times.append(round(timed(fn, n=n, warmup=warmup).min_s, 6))
    launched = ops.launch_counts()[counter] - before
    return {
        "kernel": kernel,
        "impl": "kernel" if launched > 0 else "plain",
        "backend": dev.type,
        "launches": launched,
        "batch": batch,
        "seq_len": seq_len,
        "heads": heads,
        "head_dim": head_dim,
        "n_shards": [int(x) for x in n_shards],
        "step_time_s": times,
    }


def kernel_step_surface(
    workload: str,
    n_shards: Sequence[int] = (1, 2, 4),
    **shape,
) -> Optional[Dict]:
    """The measured step-time surface for a workload's kernel hot path —
    the wall-clock sibling of the analytic ``step_time_s`` tuples in
    ``workloads/builtin.py`` (``serve_decode`` → the flash-decode
    kernel, ``train_llm`` → the flash-attention kernel). Returns None
    for workloads with no kernel hot path (``analytic``,
    ``genome_search`` time their own search in calibration). ``shape``
    passes on to :func:`time_kernel` (``device`` too: the card unless
    the caller asks for the CPU)."""
    kernel = {"serve_decode": "decode_attention", "train_llm": "flash_attention"}.get(
        workload
    )
    if kernel is None:
        return None
    out = time_kernel(kernel, n_shards=n_shards, **shape)
    out["workload"] = workload
    return out
