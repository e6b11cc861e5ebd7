"""'Are you alive?' heartbeat service + per-node health telemetry.

Each node heartbeats its ring neighbours once per tick and appends a
feature vector to its local health log (the paper's per-node log used by
the ML predictor). Telemetry is produced by a generative model conditioned
on the node's latent state:

  healthy -> degrading (entered `lead_s` before a *predictable* failure)
          -> failed

Features (6): heartbeat latency jitter, load, ECC-corrected error count,
temperature, page-fault rate, past-failure count. Degrading nodes drift
upward in the first four — the signal the predictor learns. Unpredictable
failures never leave `healthy` before dying (Fig 15b).

Correlated degradation (scenario-engine extension): nodes may be grouped
into *racks*; when a rack peer is degrading, a node's telemetry drifts
part-way toward the degrading profile (shared PSU/cooling) even while its
own latent state is still `healthy`. This is the signal the scenario
engine's rack-correlated campaigns exercise: the predictor can see a rack
outage coming from its neighbours' logs before its own node degrades.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

N_FEATURES = 6


@dataclass
class NodeHealth:
    node: int
    state: str = "healthy"  # healthy | degrading | failed
    past_failures: int = 0


class TelemetryModel:
    """Generative telemetry used both for predictor training data and at
    simulation time (different seeds)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(
        self, state: str, past_failures: int = 0, rack_stress: float = 0.0
    ) -> np.ndarray:
        """`rack_stress` in [0, 1]: fraction of rack peers currently degrading
        or failed; pulls a healthy node's thermals/ECC toward the degrading
        profile (shared power/cooling domain)."""
        r = self.rng
        if state == "degrading":
            lat = r.gamma(4.0, 0.8)  # latency jitter up
            load = 0.75 + 0.2 * r.random()
            ecc = r.poisson(6.0)
            temp = 82 + 8 * r.random()
            pf = r.gamma(3.0, 2.0)
        else:
            lat = r.gamma(2.0, 0.35)
            load = 0.35 + 0.4 * r.random()
            ecc = r.poisson(0.3)
            temp = 55 + 15 * r.random()
            pf = r.gamma(2.0, 0.6)
            if rack_stress > 0.0:
                # correlated drift: interpolate toward the degrading means
                lat += rack_stress * (3.2 - 0.7)  # gamma means: 4*0.8 vs 2*0.35
                ecc += r.poisson(6.0 * rack_stress)
                temp += rack_stress * (86.0 - 62.5)
        return np.array([lat, load, ecc, temp, pf, past_failures], np.float32)


class HeartbeatService:
    """Ring heartbeats + health logs for a cluster of n nodes."""

    def __init__(
        self,
        n_nodes: int,
        seed: int = 0,
        tick_s: float = 1.0,
        racks: Optional[Dict[int, int]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.n = n_nodes
        self.tick_s = tick_s
        self.tm = TelemetryModel(seed)
        self.health = {i: NodeHealth(i) for i in range(n_nodes)}
        self.logs: Dict[int, List[np.ndarray]] = {i: [] for i in range(n_nodes)}
        self.latency_ewma = np.zeros(n_nodes, np.float32)
        self.racks: Dict[int, int] = racks or {}  # node -> rack id
        # liveness clock is injected so stall detection is testable with a
        # fake clock; the default reference is only *called* when a caller
        # doesn't pass explicit beat/now timestamps (the orchestrator daemon
        # always does, keeping simulation paths wall-clock-free)
        self.clock: Callable[[], float] = clock if clock is not None else time.monotonic
        self.last_beat_s: Dict[int, float] = {}

    def add_node(self, rack: Optional[int] = None) -> int:
        """Grow the service with the cluster: a newly provisioned host
        joins the heartbeat ring with a fresh health record, an empty log
        and a zeroed latency EWMA (``ClusterRuntime.provision_spare``
        calls this when it provisions a host id beyond the original n)."""
        i = self.n
        self.n += 1
        self.health[i] = NodeHealth(i)
        self.logs[i] = []
        self.latency_ewma = np.append(self.latency_ewma, np.float32(0.0))
        if rack is not None:
            self.racks[i] = int(rack)
        return i

    def neighbours(self, i: int):
        return [(i - 1) % self.n, (i + 1) % self.n]

    def rack_peers(self, i: int) -> List[int]:
        r = self.racks.get(i)
        if r is None:
            return []
        return [j for j, rj in self.racks.items() if rj == r and j != i]

    def rack_stress(self, i: int) -> float:
        """Fraction of rack peers currently degrading or failed."""
        peers = self.rack_peers(i)
        if not peers:
            return 0.0
        bad = sum(1 for p in peers if self.health[p].state != "healthy")
        return bad / len(peers)

    def mark_degrading(self, node: int):
        if self.health[node].state == "healthy":
            self.health[node].state = "degrading"

    def mark_failed(self, node: int):
        self.health[node].state = "failed"
        self.health[node].past_failures += 1

    def revive(self, node: int):
        self.health[node].state = "healthy"

    def alive(self, node: int) -> bool:
        return self.health[node].state != "failed"

    # ----------------------------------------------------- liveness beats ---
    def beat(self, node: int, at_s: Optional[float] = None):
        """Record a liveness beat from ``node`` at ``at_s`` (injected-clock
        "now" when omitted). The orchestrator daemon forwards each real
        worker heartbeat here, so stall detection is one shared code path
        for simulated and live clusters."""
        self.last_beat_s[node] = self.clock() if at_s is None else float(at_s)

    def stalled(self, timeout_s: float, now_s: Optional[float] = None) -> List[int]:
        """Nodes whose last beat is older than ``timeout_s`` at ``now_s``
        (injected-clock "now" when omitted). Only nodes that have beaten
        at least once and are not already marked failed are considered —
        silence from a known-dead node is not a *new* stall."""
        now = self.clock() if now_s is None else float(now_s)
        return [
            i
            for i, t in sorted(self.last_beat_s.items())
            if self.alive(i) and now - t > timeout_s
        ]

    def tick(self) -> Dict[int, np.ndarray]:
        """One heartbeat round; returns {node: latest features}."""
        out = {}
        for i in range(self.n):
            h = self.health[i]
            if h.state == "failed":
                continue
            f = self.tm.sample(h.state, h.past_failures, self.rack_stress(i))
            self.logs[i].append(f)
            self.latency_ewma[i] = 0.9 * self.latency_ewma[i] + 0.1 * f[0]
            out[i] = f
        return out
