"""Approach 2 — fault tolerance incorporating CORE intelligence.

Virtual cores are a logical abstraction over hardware cores. Each VC
monitors its neighbours ('are you alive?'), self-probes, and when a failure
is predicted *pushes the sub-job* to a healthy adjacent VC. Dependencies
are repaired automatically by the runtime's routing table (no per-edge
handshakes) — closer to the hardware in the communication stack, hence the
paper's faster reinstate times (Fig 9 vs Fig 8).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.migration import move_state, reestablish_deps_core
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.strategies.placement import PlacementPolicy


@dataclass
class VirtualCore:
    vid: int
    host: int
    # target selection is a pluggable policy; None -> the runtime's default
    placement: Optional[PlacementPolicy] = None

    def self_probe(self, rt: ClusterRuntime) -> bool:
        log = rt.heartbeats.logs[self.host]
        if rt.predictor is None or not log:
            return False
        return rt.predictor.predict(log[-1])

    def monitor_neighbours(self, rt: ClusterRuntime) -> Dict[int, bool]:
        """'Are you alive?' to adjacent cores (paper: independent of what
        the cores are executing)."""
        return {nb: rt.healthy(nb) for nb in rt.neighbours(self.host)}

    def migrate_job(self, rt: ClusterRuntime, target: Optional[int] = None) -> Dict:
        """Step 3.2.1: migrate sub-job on VC_i onto an adjacent core VC_a."""
        old = self.host
        if target is None:
            target = (self.placement or rt.placement).pick(rt, old)
        assert target is not None, "no healthy target available"
        shard = rt.hosts[old].shard
        moved, mrep = move_state(shard, rt.profile)  # raw shard, no wrapper
        reest = reestablish_deps_core(rt.graph, old, target, rt.profile)
        rt.release(old)
        rt.occupy(target, moved, f"core:{self.vid}")
        self.host = target
        rep = {
            "kind": "core",
            "from": old,
            "to": target,
            "bytes": mrep.bytes_moved,
            "edges": reest.edges,
            "reinstate_measured_s": reest.control_measured_s,
            "reinstate_modelled_s": mrep.control_modelled_s + reest.control_modelled_s,
            "staging_measured_s": mrep.staging_measured_s,
            "staging_modelled_s": mrep.staging_modelled_s,
            "hash_ok": mrep.hash_ok,
        }
        rep["reinstate_s"] = rep["reinstate_measured_s"] + rep["reinstate_modelled_s"]
        rep["staging_s"] = rep["staging_measured_s"] + rep["staging_modelled_s"]
        rt.events.append(rep)
        return rep
