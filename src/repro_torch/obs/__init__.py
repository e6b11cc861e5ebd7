"""Campaign observability: structured traces, metric frames, exporters,
and profiling hooks.

The subsystem is strictly opt-in and zero-overhead when unused: the
engine's recorder is ``None`` unless ``trace=True``, the replay fold only
returns per-slot arrays under ``record_slots=True`` (a separate cached
program), and the profiling hooks are plain functions that cost nothing
until called.

Layout — submodules import lazily, so ``repro_torch.obs.profile`` (pure
stdlib at import) never drags the scenario machinery in:

``obs.trace``
    typed event timelines from the engine, and the exact reconstruction
    of the same timeline from the replay fold's per-slot records
``obs.metrics``
    per-campaign time-in-state frames (sum to the billed total by
    construction), cross-seed p5/p50/p95 aggregation, SLO summaries,
    availability timelines, verdict ledgers
``obs.export``
    Chrome-trace / Perfetto JSON serialisation
``obs.profile``
    the port's one wall-clock timing idiom (``timed``/``stopwatch``),
    build-vs-execute splits + seeds/sec for the replay fold, measured
    CUDA attention-kernel step surfaces per shard count
"""
from __future__ import annotations

from repro_torch.obs.profile import (  # noqa: F401  (dependency-free, eager)
    Timed,
    kernel_step_surface,
    now_s,
    profile_replay,
    stopwatch,
    time_kernel,
    timed,
)

_LAZY = {
    "TraceEvent": "repro_torch.obs.trace",
    "CampaignTrace": "repro_torch.obs.trace",
    "TraceRecorder": "repro_torch.obs.trace",
    "reconstruct_traces": "repro_torch.obs.trace",
    "MODE_OUTCOME": "repro_torch.obs.trace",
    "MetricFrame": "repro_torch.obs.metrics",
    "frame_from_result": "repro_torch.obs.metrics",
    "frames_from_replay": "repro_torch.obs.metrics",
    "aggregate_frames": "repro_torch.obs.metrics",
    "aggregate_slo": "repro_torch.obs.metrics",
    "availability_timeline": "repro_torch.obs.metrics",
    "verdict_ledger": "repro_torch.obs.metrics",
    "to_chrome_trace": "repro_torch.obs.export",
    "write_chrome_trace": "repro_torch.obs.export",
}

__all__ = [
    "Timed",
    "timed",
    "stopwatch",
    "now_s",
    "profile_replay",
    "time_kernel",
    "kernel_step_surface",
    *_LAZY,
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
