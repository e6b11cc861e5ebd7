"""The paper's contribution: multi-agent proactive fault tolerance.

Approach 1 (agent intelligence)  -> repro_torch.core.agent
Approach 2 (core intelligence)   -> repro_torch.core.virtual_core
Approach 3 (hybrid + Rules 1-3)  -> repro_torch.core.hybrid / repro_torch.core.rules
Failure prediction (29%/64%)     -> repro_torch.core.predictor
Checkpointing baselines          -> repro_torch.core.checkpoint
Tables 1-2 simulator             -> repro_torch.core.sim

Straggler detection / mitigation -> repro_torch.core.straggler

The reference's ``repro/core/__init__.py`` also imports its trainer, which
closes a circular import through ``repro.telemetry``; the port's trainer,
elastic re-meshing and speculative modules are later slices, and this
package imports none of them, so ``import repro_torch.telemetry`` works
cold.
"""
from repro_torch.core.agent import Agent
from repro_torch.core.virtual_core import VirtualCore
from repro_torch.core.hybrid import HybridUnit
from repro_torch.core.rules import decide, negotiate, Decision
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.predictor import FailurePredictor
from repro_torch.core.failure import FailureModel, FailureEvent
from repro_torch.core.checkpoint import CheckpointStore, AsyncCheckpointer
from repro_torch.core.straggler import StragglerDetector, mitigate, sync_step_time
