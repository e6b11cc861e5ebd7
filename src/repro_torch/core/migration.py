"""State egress/ingress and dependency re-establishment.

Everything here actually executes (real serialization, real buffer moves,
real dependency-graph surgery, hash-verified) and is wall-clock measured;
network/spawn components that cannot exist in one process are *modelled*
from the cluster profile and accounted separately. Every cost report keeps
the two tiers apart: {"measured_s": ..., "modelled_s": ...}.

Key asymmetry from the paper (the source of Rules 1-3):
  * an agent re-establishes its Z dependency edges ONE AT A TIME
    (2 messages each) and carries its payload through a serialize ->
    transfer -> deserialize path (an extra software layer);
  * a virtual core migrates the raw shard and the runtime's routing table
    repairs all edges in one pass (constant small cost + Z pointer writes).

Beyond-paper: ``reestablish_deps_batched`` groups the agent's Z handshakes
into one exchange — removing the paper's Z-linear term (EXPERIMENTS.md §Perf).
"""
from __future__ import annotations

import io
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterProfile
from repro_torch.utils.tree import tree_hash


@dataclass
class DependencyGraph:
    """in_edges[node] = producers feeding it; out_edges[node] = consumers."""

    in_edges: Dict[int, List[int]] = field(default_factory=dict)
    out_edges: Dict[int, List[int]] = field(default_factory=dict)

    @staticmethod
    def reduction_tree(n_leaves: int, fan_in: int = 2) -> "DependencyGraph":
        """Bottom-up parallel-reduction topology (paper Fig. 7)."""
        g = DependencyGraph()
        nodes = list(range(n_leaves))
        nxt = n_leaves
        frontier = nodes[:]
        while len(frontier) > 1:
            nf = []
            for i in range(0, len(frontier), fan_in):
                grp = frontier[i : i + fan_in]
                parent = nxt
                nxt += 1
                for c in grp:
                    g.out_edges.setdefault(c, []).append(parent)
                    g.in_edges.setdefault(parent, []).append(c)
                nf.append(parent)
            frontier = nf
        return g

    @staticmethod
    def star(n_search: int) -> "DependencyGraph":
        """Genome-search topology: n search nodes -> 1 combiner (paper §Genome)."""
        g = DependencyGraph()
        comb = n_search
        for i in range(n_search):
            g.out_edges.setdefault(i, []).append(comb)
            g.in_edges.setdefault(comb, []).append(i)
        return g

    def degree(self, node: int) -> int:
        return len(self.in_edges.get(node, [])) + len(self.out_edges.get(node, []))

    def remap(self, old: int, new: int):
        """Repair every edge touching `old` to point at `new` (core-runtime
        routing-table pass). Returns number of pointer writes."""
        writes = 0
        self.in_edges[new] = self.in_edges.pop(old, [])
        self.out_edges[new] = self.out_edges.pop(old, [])
        for node, outs in self.out_edges.items():
            for i, o in enumerate(outs):
                if o == old:
                    outs[i] = new
                    writes += 1
        for node, ins in self.in_edges.items():
            for i, o in enumerate(ins):
                if o == old:
                    ins[i] = new
                    writes += 1
        return writes + len(self.in_edges.get(new, [])) + len(self.out_edges.get(new, []))


def serialize_state(state) -> bytes:
    buf = io.BytesIO()
    pickle.dump(state, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def deserialize_state(blob: bytes):
    return pickle.loads(blob)


@dataclass
class MoveReport:
    """Costs split the way the paper accounts them:

    * control (reinstate time, Figs 8-13 / Tables 1-2 'reinstating
      execution'): process spawn, registration, dependency handshakes,
      state-metadata negotiation — sub-second;
    * staging (part of 'overhead time'): serializing + wiring the payload
      bytes themselves (can be overlapped / pre-staged — beyond-paper).
    """

    bytes_moved: int
    control_measured_s: float = 0.0
    control_modelled_s: float = 0.0
    staging_measured_s: float = 0.0
    staging_modelled_s: float = 0.0
    hash_ok: bool = True
    edges: int = 0

    @property
    def reinstate_s(self):
        return self.control_measured_s + self.control_modelled_s

    @property
    def staging_s(self):
        return self.staging_measured_s + self.staging_modelled_s


META_LOG_COEF = 0.0075  # s per log2(byte) of payload-metadata negotiation


def move_state(state, profile: ClusterProfile, verify: bool = True) -> Tuple[object, MoveReport]:
    """Serialize -> (modelled wire) -> deserialize, hash-verified.

    The real pickle round-trip is measured (staging tier); the modelled
    control tier covers spawn + metadata negotiation which cannot exist
    in-process."""
    t0 = time.perf_counter()
    src_hash = tree_hash(state) if verify else ""
    blob = serialize_state(state)
    new_state = deserialize_state(blob)
    ok = (tree_hash(new_state) == src_hash) if verify else True
    staging_measured = time.perf_counter() - t0
    nbytes = max(len(blob), 1)
    speed = max(profile.node_speed, 0.1)
    control_modelled = (
        profile.proc_spawn_s
        + 2 * profile.msg_latency_s
        + META_LOG_COEF * float(np.log2(nbytes)) / speed
    )
    staging_modelled = nbytes / profile.node_bw + nbytes / profile.ser_bytes_per_s
    return new_state, MoveReport(
        nbytes,
        control_measured_s=0.0,
        control_modelled_s=control_modelled,
        staging_measured_s=staging_measured,
        staging_modelled_s=staging_modelled,
        hash_ok=ok,
    )


def reestablish_deps_agent(
    graph: DependencyGraph, old: int, new: int, profile: ClusterProfile
) -> MoveReport:
    """Paper behaviour: the agent notifies each input/output dependent and
    re-establishes each edge individually (2 one-way messages per edge)."""
    t0 = time.perf_counter()
    ins = list(graph.in_edges.get(old, []))
    outs = list(graph.out_edges.get(old, []))
    z = len(ins) + len(outs)
    # real graph surgery, one edge at a time
    graph.in_edges[new] = []
    graph.out_edges[new] = []
    for p in ins:
        graph.out_edges[p] = [new if x == old else x for x in graph.out_edges.get(p, [])]
        graph.in_edges[new].append(p)
    for c in outs:
        graph.in_edges[c] = [new if x == old else x for x in graph.in_edges.get(c, [])]
        graph.out_edges[new].append(c)
    graph.in_edges.pop(old, None)
    graph.out_edges.pop(old, None)
    measured = time.perf_counter() - t0
    # per-edge: notify + ack + re-register (paper's Z-linear term), plus the
    # agent software layer's registration pass
    speed = max(profile.node_speed, 0.1)
    modelled = z * (2 * profile.msg_latency_s + 0.9e-3 / speed) + 0.1489 / speed
    return MoveReport(0, control_measured_s=measured, control_modelled_s=modelled, edges=z)


def reestablish_deps_batched(
    graph: DependencyGraph, old: int, new: int, profile: ClusterProfile
) -> MoveReport:
    """Beyond-paper: one grouped exchange carrying all Z edge records."""
    t0 = time.perf_counter()
    z = graph.degree(old)
    graph.remap(old, new)
    measured = time.perf_counter() - t0
    speed = max(profile.node_speed, 0.1)
    modelled = 2 * profile.msg_latency_s + z * 64 / profile.node_bw + 3e-3 / speed
    return MoveReport(0, control_measured_s=measured, control_modelled_s=modelled, edges=z)


def reestablish_deps_core(
    graph: DependencyGraph, old: int, new: int, profile: ClusterProfile
) -> MoveReport:
    """Core runtime: routing-table pass repairs all edges automatically;
    cost is one table update broadcast + Z pointer writes (cheap, flat-ish
    in Z — the paper's Fig 9 observation)."""
    t0 = time.perf_counter()
    writes = graph.remap(old, new)
    measured = time.perf_counter() - t0
    speed = max(profile.node_speed, 0.1)
    modelled = 2 * profile.msg_latency_s + writes * 2e-5 / speed + 0.055 / speed
    return MoveReport(0, control_measured_s=measured, control_modelled_s=modelled, edges=writes)
