"""Campaign observability: per-campaign metric frames and their cross-seed
aggregation (:mod:`repro_torch.obs.metrics`, pure numpy).

The reference's structured traces, Chrome-trace export and profiling hooks
(``obs/{trace, export, profile}``) are a later slice of the port (ROADMAP
Queue 1, item 8).
"""
from repro_torch.obs.metrics import (
    MetricFrame,
    aggregate_frames,
    aggregate_slo,
    availability_timeline,
    frame_from_result,
    frames_from_replay,
    verdict_ledger,
)

__all__ = [
    "MetricFrame",
    "aggregate_frames",
    "aggregate_slo",
    "availability_timeline",
    "frame_from_result",
    "frames_from_replay",
    "verdict_ledger",
]
