"""Cluster runtime: virtual hosts, landscape knowledge, spare selection.

The unit of failure is a host/core; each host owns a *shard* (the sub-job
payload: partial results, model state slice, data cursor). Agents and
virtual cores both live on top of this runtime — they differ in who probes,
who moves, and how dependencies are re-established (see agent.py /
virtual_core.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cluster import ClusterProfile, get_profile
from repro_torch.core.heartbeat import HeartbeatService
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.predictor import FailurePredictor
from repro_torch.strategies.placement import PlacementPolicy, get_placement


@dataclass
class VirtualHost:
    hid: int
    shard: object = None
    is_spare: bool = True
    owner: Optional[str] = None  # "agent:<i>" | "core:<i>" | None


class ClusterRuntime:
    def __init__(
        self,
        n_hosts: int,
        n_spares: int = 2,
        profile: str | ClusterProfile = "placentia",
        graph: Optional[DependencyGraph] = None,
        seed: int = 0,
        racks: Optional[Dict[int, int]] = None,
        placement: str | PlacementPolicy = "nearest-spare",
    ):
        self.profile = get_profile(profile) if isinstance(profile, str) else profile
        self.hosts: Dict[int, VirtualHost] = {
            i: VirtualHost(i) for i in range(n_hosts + n_spares)
        }
        self.n_active = n_hosts
        self.spares: List[int] = list(range(n_hosts, n_hosts + n_spares))
        self.heartbeats = HeartbeatService(n_hosts + n_spares, seed=seed, racks=racks)
        self.graph = graph or DependencyGraph.reduction_tree(n_hosts)
        self.predictor: Optional[FailurePredictor] = None
        self.events: List[dict] = []
        self.blacklist: set = set()  # hosts barred from ever hosting work again
        self.placement = get_placement(placement)  # the runtime's default policy
        self.partition: Optional[Dict[int, int]] = None  # host -> component id

    # --- landscape knowledge (paper: agent knows its core + vicinity) -----
    def neighbours(self, hid: int) -> List[int]:
        return self.heartbeats.neighbours(hid)

    def healthy(self, hid: int) -> bool:
        return self.heartbeats.alive(hid)

    def neighbour_predictions(self, hid: int) -> Dict[int, bool]:
        """Gather failure predictions from adjacent hosts' probes (the paper's
        failure-scenario refinement: the adjacent core may also fail)."""
        out = {}
        for nb in self.neighbours(hid):
            if not self.healthy(nb):
                out[nb] = True
                continue
            log = self.heartbeats.logs[nb]
            if self.predictor is not None and log:
                out[nb] = self.predictor.predict(log[-1])
            else:
                out[nb] = False
        return out

    def pick_target(self, failing: int, require_free: bool = False) -> Optional[int]:
        """Delegate to the runtime's default :class:`PlacementPolicy`
        (``nearest-spare`` unless overridden at construction): prefer a
        healthy spare; else a healthy adjacent host that is not itself
        predicted to fail. Blacklisted hosts are never chosen.

        Strategies carry their own injected placement policy and call it
        directly; this method remains as the runtime-level default."""
        return self.placement.pick(self, failing, require_free=require_free)

    # --- network partitions (partition-aware placement, quorum) -----------
    def set_partition(self, components: Dict[int, int]):
        """Split the cluster: heartbeats cross the cut but migrations must
        not — the ``partition-aware`` placement policy honours this map."""
        self.partition = dict(components)

    def heal_partition(self):
        self.partition = None

    def same_component(self, a: int, b: int) -> bool:
        return self.partition is None or self.partition.get(a) == self.partition.get(b)

    # --- scenario-engine hooks: blacklisting & spare re-provisioning ------
    def fail(self, hid: int, permanent: bool = False):
        """Mark a host failed; optionally bar it from re-provisioning."""
        self.heartbeats.mark_failed(hid)
        if permanent:
            self.blacklist.add(hid)
        if hid in self.spares:
            self.spares.remove(hid)

    def provision_spare(self, hid: int) -> bool:
        """Return a repaired host to the spare pool (unless blacklisted).

        Also accepts a brand-new host id: the cluster grows, and the
        heartbeat ring / latency EWMA / health logs grow with it
        (``HeartbeatService.add_node``) instead of staying sized at the
        original n."""
        if hid in self.blacklist:
            return False
        while self.heartbeats.n <= hid:
            # every grown ring slot gets a matching VirtualHost, so a gap
            # id never leaves phantom heartbeat nodes without hosts
            new = self.heartbeats.add_node()
            self.hosts.setdefault(new, VirtualHost(new))
        self.heartbeats.revive(hid)
        h = self.hosts[hid]
        h.shard = None
        h.owner = None
        h.is_spare = True
        if hid not in self.spares:
            self.spares.append(hid)
        return True

    def available_targets(self) -> List[int]:
        """Healthy, un-blacklisted, unoccupied hosts (capacity headroom)."""
        return [
            hid
            for hid, h in self.hosts.items()
            if hid not in self.blacklist and self.healthy(hid) and h.shard is None
        ]

    def occupy(self, hid: int, shard, owner: str):
        """Place `shard` on `hid`. NOTE: re-occupying a busy host replaces
        its shard — the paper's migration target may be an adjacent core
        that is already running a sub-job (co-hosting), so this is legal at
        this layer; callers that must not co-host (e.g. the scenario
        engine) pick a free target first (see available_targets)."""
        h = self.hosts[hid]
        h.shard = shard
        h.owner = owner
        h.is_spare = False
        if hid in self.spares:
            self.spares.remove(hid)

    def release(self, hid: int):
        h = self.hosts[hid]
        h.shard = None
        h.owner = None
