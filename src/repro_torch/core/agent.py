"""Approach 1 — fault tolerance incorporating AGENT intelligence.

An agent wraps a sub-job as its payload and situates it on a host. The
agent (a) knows the landscape, (b) probes its host each tick, (c) predicts
failure via the ML predictor, (d) moves itself (payload + agent metadata)
onto a healthy adjacent host, then notifies dependents and re-establishes
its Z dependency edges one at a time (the paper's measured Z-linear cost).

The agent is a software layer *above* the runtime: its payload crosses an
extra serialize/copy boundary compared to the virtual-core path — the
paper's explanation for why core intelligence re-instates faster.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.migration import (
    MoveReport,
    move_state,
    reestablish_deps_agent,
    reestablish_deps_batched,
    serialize_state,
)
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.strategies.placement import PlacementPolicy


@dataclass
class Agent:
    aid: int
    host: int
    payload: object
    meta: dict = field(default_factory=dict)
    # target selection is a pluggable policy; None -> the runtime's default
    placement: Optional[PlacementPolicy] = None

    def probe(self, rt: ClusterRuntime) -> bool:
        """Periodically probe the hardware of the current host (Step 4.1)."""
        log = rt.heartbeats.logs[self.host]
        if rt.predictor is None or not log:
            return False
        return rt.predictor.predict(log[-1])

    def migrate(self, rt: ClusterRuntime, target: Optional[int] = None,
                batched_deps: bool = False) -> Dict:
        """Steps 4.2.1-4.2.3: move to adjacent core, notify dependents,
        re-establish dependencies."""
        old = self.host
        if target is None:
            target = (self.placement or rt.placement).pick(rt, old)
        assert target is not None, "no healthy target available"

        t0 = time.perf_counter()
        # agent wrapper: payload + agent metadata cross the software layer
        wrapper = {"payload": self.payload, "meta": self.meta, "aid": self.aid}
        moved, mrep = move_state(wrapper, rt.profile)
        self.payload = moved["payload"]
        wrapper_s = time.perf_counter() - t0 - mrep.staging_measured_s

        reest = (
            reestablish_deps_batched(rt.graph, old, target, rt.profile)
            if batched_deps
            else reestablish_deps_agent(rt.graph, old, target, rt.profile)
        )
        rt.release(old)
        rt.occupy(target, self.payload, f"agent:{self.aid}")
        self.host = target
        rep = {
            "kind": "agent",
            "from": old,
            "to": target,
            "bytes": mrep.bytes_moved,
            "edges": reest.edges,
            # reinstate = control plane (paper Figs 8-13 quantity)
            "reinstate_measured_s": reest.control_measured_s + wrapper_s,
            "reinstate_modelled_s": mrep.control_modelled_s + reest.control_modelled_s,
            # staging = payload bytes (part of the paper's 'overhead time')
            "staging_measured_s": mrep.staging_measured_s,
            "staging_modelled_s": mrep.staging_modelled_s,
            "hash_ok": mrep.hash_ok,
        }
        rep["reinstate_s"] = rep["reinstate_measured_s"] + rep["reinstate_modelled_s"]
        rep["staging_s"] = rep["staging_measured_s"] + rep["staging_modelled_s"]
        rt.events.append(rep)
        return rep
