"""Elastic scaling: shrink/grow the logical worker set on permanent node
loss — the core-intelligence idea applied at mesh level (no spare left ->
re-mesh instead of migrate). Counterpart of ``repro/core/elastic.py``.

`replan` computes a new host->shard assignment when the active set changes;
`reshard_batch` rebalances the global batch across survivors. The
reference's ``remesh_rules`` (rebuild the sharding rules on a smaller data
axis) waits for the port's ``sharding/`` slice (ROADMAP.md Queue 1,
item 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Plan:
    assignment: Dict[int, List[int]]  # host -> shard ids
    moved: List[int]  # shard ids that must move


def replan(n_shards: int, alive_hosts: List[int], old: Optional[Plan] = None) -> Plan:
    """Round-robin shards over surviving hosts, minimising movement."""
    alive = sorted(alive_hosts)
    assert alive, "no hosts alive"
    target = {h: [] for h in alive}
    moved = []
    # keep shards that stay on alive hosts
    placed = set()
    if old:
        for h, shs in old.assignment.items():
            if h in target:
                for s in shs:
                    target[h].append(s)
                    placed.add(s)
    # place the rest on least-loaded hosts
    for s in range(n_shards):
        if s in placed:
            continue
        h = min(alive, key=lambda x: len(target[x]))
        target[h].append(s)
        moved.append(s)
    return Plan(assignment=target, moved=moved)


def reshard_batch(global_batch: int, n_alive: int) -> List[int]:
    """Per-host batch sizes after a shrink (keeps the global batch)."""
    base = global_batch // n_alive
    rem = global_batch - base * n_alive
    return [base + (1 if i < rem else 0) for i in range(n_alive)]
