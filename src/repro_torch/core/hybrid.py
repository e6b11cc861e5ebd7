"""Approach 3 — hybrid fault tolerance (agents ON virtual cores).

Agents carry sub-jobs as payloads onto virtual cores; when a failure is
predicted both the agent and the core can respond, so they negotiate using
the empirically-derived Rules 1-3 before either initiates the move
(paper Fig. 6)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.agent import Agent
from repro_torch.core.rules import Decision, decide, negotiate
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.virtual_core import VirtualCore
from repro_torch.utils.tree import tree_bytes


@dataclass
class HybridUnit:
    agent: Agent
    core: VirtualCore

    @property
    def host(self) -> int:
        return self.agent.host

    def probe(self, rt: ClusterRuntime) -> bool:
        return self.agent.probe(rt) or self.core.self_probe(rt)

    def handle_prediction(
        self, rt: ClusterRuntime, s_d_bytes: Optional[int] = None,
        s_p_bytes: Optional[int] = None, target: Optional[int] = None
    ) -> Dict:
        z = rt.graph.degree(self.host)
        s_d = s_d_bytes if s_d_bytes is not None else tree_bytes(self.agent.payload)
        s_p = s_p_bytes if s_p_bytes is not None else s_d
        # both parties form a preference, then negotiate via the rules
        agent_pref = "agent"
        core_pref = "core"
        dec = negotiate(agent_pref, core_pref, z, s_d, s_p)
        if dec.mechanism == "agent":
            rep = self.agent.migrate(rt, target)
            self.core.host = self.agent.host
        else:
            rep = self.core.migrate_job(rt, target)
            self.agent.host = self.core.host
            self.agent.payload = rt.hosts[self.core.host].shard
        rep["decision"] = dec.rule
        rep["mechanism"] = dec.mechanism
        return rep
