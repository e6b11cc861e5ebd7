"""The paper's contribution: multi-agent proactive fault tolerance.

Approach 1 (agent intelligence)  -> repro_torch.core.agent
Approach 2 (core intelligence)   -> repro_torch.core.virtual_core
Approach 3 (hybrid + Rules 1-3)  -> repro_torch.core.hybrid / repro_torch.core.rules
Failure prediction (29%/64%)     -> repro_torch.core.predictor
Checkpointing baselines          -> repro_torch.core.checkpoint
Tables 1-2 simulator             -> repro_torch.core.sim

Straggler detection / mitigation -> repro_torch.core.straggler
FT training loop (Fig 15)        -> repro_torch.core.trainer (FTTrainer, FTReport)
Elastic re-planning              -> repro_torch.core.elastic
Speculative state egress         -> repro_torch.core.speculative

The reference's ``repro/core/__init__.py`` imports its trainer, which
closes a circular import through ``repro.telemetry``. Here ``FTTrainer``
and ``FTReport`` load on first attribute access instead, so
``import repro_torch.telemetry`` works cold.
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


def __getattr__(name):
    if name in ("FTTrainer", "FTReport"):
        from repro_torch.core import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
