"""Decision-making rules (paper §Decision Making Rules), used by the hybrid
approach to pick agent vs core intelligence when a failure is predicted.

  Rule 1: Z <= 10                -> core intelligence, else either
  Rule 2: S_d <= 2^24 KB         -> agent intelligence, else either
  Rule 3: S_p <= 2^24 KB         -> agent intelligence, else either

Ties are broken toward core intelligence (the paper's Table 1 experiment
selects core because its reinstate/overhead times are lower).
"""
from __future__ import annotations

from dataclasses import dataclass

Z_THRESHOLD = 10
SD_THRESHOLD_BYTES = (2 ** 24) * 1024  # 2^24 KB
SP_THRESHOLD_BYTES = (2 ** 24) * 1024


@dataclass(frozen=True)
class Decision:
    mechanism: str  # "agent" | "core"
    rule: str
    rationale: str


def decide(z: int, s_d_bytes: int, s_p_bytes: int) -> Decision:
    """Apply Rules 1-3 in order; first decisive rule wins; tie -> core."""
    if z <= Z_THRESHOLD:
        return Decision("core", "rule1", f"Z={z} <= {Z_THRESHOLD}")
    if s_d_bytes <= SD_THRESHOLD_BYTES:
        return Decision("agent", "rule2", f"S_d={s_d_bytes} <= 2^24 KB")
    if s_p_bytes <= SP_THRESHOLD_BYTES:
        return Decision("agent", "rule3", f"S_p={s_p_bytes} <= 2^24 KB")
    return Decision("core", "tie", "no rule decisive; core has lower reinstate cost")


def negotiate(agent_choice: str, core_choice: str, z, s_d, s_p) -> Decision:
    """Conflict negotiation (paper Fig. 6): when both the agent and the core
    want to initiate the move, the rules arbitrate; agreement short-circuits."""
    if agent_choice == core_choice:
        return Decision(agent_choice, "agree", "no conflict")
    return decide(z, s_d, s_p)
