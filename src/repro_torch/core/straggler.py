"""Straggler detection and mitigation.

In a synchronous SPMD step the slowest host sets the pace. The detector
keeps an EWMA + variance of per-host heartbeat/step latencies and flags
hosts whose z-score exceeds a threshold; mitigation either rebalances work
away from the straggler (shrinking its shard) or migrates its sub-job via
the core mechanism (same machinery as fault handling — the paper's mobility
primitive reused for performance)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class StragglerDetector:
    n_hosts: int
    alpha: float = 0.2
    z_threshold: float = 2.5
    warmup: int = 8
    mean: Optional[np.ndarray] = field(default=None)
    var: Optional[np.ndarray] = field(default=None)
    count: int = 0

    def __post_init__(self):
        # init only when unset, so dataclasses.replace() carries the EWMA
        # state over instead of silently resetting it
        if self.mean is None:
            self.mean = np.zeros(self.n_hosts)
        if self.var is None:
            self.var = np.ones(self.n_hosts) * 1e-6

    def observe(self, latencies: np.ndarray) -> List[int]:
        """Update with per-host step latencies; return flagged hosts."""
        self.count += 1
        d = latencies - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if self.count < self.warmup:
            return []
        pool_mu = float(np.median(self.mean))
        pool_sd = float(np.median(np.sqrt(self.var)) + 1e-9)
        z = (self.mean - pool_mu) / pool_sd
        return [int(i) for i in np.where(z > self.z_threshold)[0]]


def mitigate(
    per_host_batch: List[int], stragglers: List[int], factor: float = 0.5
) -> List[int]:
    """Shift work away from stragglers; keep the global batch constant."""
    out = list(per_host_batch)
    healthy = [i for i in range(len(out)) if i not in stragglers]
    if not healthy:
        return out
    for s in stragglers:
        take = int(out[s] * factor)
        if take == 0 and out[s] > 0 and factor > 0:
            # small shards must still shed work: int() rounding to 0 left
            # the straggler pacing the whole step
            take = 1
        out[s] -= take
        for j, h in enumerate(healthy):
            out[h] += take // len(healthy) + (1 if j < take % len(healthy) else 0)
    return out


def sync_step_time(per_host_batch: List[int], speeds: np.ndarray, base_s: float = 1.0):
    """Synchronous step = max over hosts of (work / speed)."""
    w = np.asarray(per_host_batch, float)
    return float(np.max(w / np.maximum(speeds, 1e-6))) * base_s / max(np.mean(w), 1e-9)
