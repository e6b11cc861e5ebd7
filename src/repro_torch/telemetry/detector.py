"""The unified detection API: ``observe(t, frame) -> [Verdict]``.

This is the observation-side twin of the
:class:`~repro_torch.strategies.base.FaultToleranceStrategy` protocol (the
action side): one protocol covers everything the repo previously encoded
three different ways — the oracle ``ev.predictable`` branch in the
scenario engine, ``FTTrainer``'s private ``FailurePredictor`` path, and
the free-standing ``StragglerDetector`` loop. A detector turns telemetry
frames into :class:`Verdict` records; *who acts on a verdict* (strategy
``on_prediction``, trainer migration, batch rebalance) stays with the
caller, so detection quality is a swappable axis of every experiment.

Two evaluation paths, mirroring the strategy protocol's scalar/vector
split:

* **live** — :meth:`Detector.observe` scores one
  :class:`~repro_torch.telemetry.frame.TelemetryFrame` (the trainer's
  per-step loop);
* **compiled** — :meth:`Detector.verdict_tape` pre-samples one verdict
  per event slot of a compiled trajectory tape, in schedule order (the
  same idiom as the tape's pre-sampled repair draws), so the Python
  :class:`~repro_torch.scenarios.engine.CampaignEngine` and the batched replay
  fold consume *identical* per-event verdicts and stay trial-for-trial
  interchangeable under any detector.

Register implementations with :func:`repro_torch.telemetry.registry.register`;
anything in the registry is immediately drivable by the engine, the
trainer, ``mc_trajectories`` and the benchmark's precision/recall report.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

from repro_torch.telemetry.frame import HealthSignal, TelemetryFrame, synth_event_telemetry

VERDICT_KINDS = ("failure_predicted", "straggler", "healthy")


@dataclass(frozen=True)
class Verdict:
    """One detector claim about one node at one instant."""

    node: int
    kind: str  # "failure_predicted" | "straggler" | "healthy"
    confidence: float = 1.0
    lead_s: float = 0.0  # detector's lead-time estimate (0: no lead window)
    detector: str = "?"

    def __post_init__(self):
        if self.kind not in VERDICT_KINDS:
            raise ValueError(f"unknown verdict kind {self.kind!r}; one of {VERDICT_KINDS}")


class Detector(ABC):
    """Base class for every telemetry detector.

    Class attributes describe the detector's shape:

    ``flags_stragglers``
        emits ``straggler`` verdicts — the scenario engine then mitigates
        ``degrade`` windows by rebalancing work off the slow shard.
    """

    name: str = "?"
    flags_stragglers: bool = False
    #: where a detector that computes runs (``ml`` trains its predictor
    #: there); :func:`repro_torch.telemetry.resolve` sets it
    device: str = "cuda"

    def bind(self, rt) -> "Detector":
        """Optional hook: grab shared resources (e.g. the runtime's trained
        ``FailurePredictor``) before observation starts. Returns self."""
        return self

    # ------------------------------------------------------------- live ---
    @abstractmethod
    def observe(self, t: float, frame: TelemetryFrame) -> List[Verdict]:
        """Score one telemetry frame; return verdicts for flagged nodes
        only (healthy nodes may be omitted)."""

    # --------------------------------------------------------- compiled ---
    def verdict_tape(
        self,
        spec,
        times: np.ndarray,
        predictable: np.ndarray,
        rack_corr: np.ndarray,
        seed: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-sample one ``failure_predicted`` verdict per event slot, in
        schedule order: ``(predicted bool[n], lead_s float[n])``.

        The default synthesises each victim's health-log features at the
        event instant (:func:`synth_event_telemetry`, slot-keyed rng) and
        routes them through :meth:`observe` — so a custom detector only
        has to implement the live path to run in compiled campaigns.
        Adapters override for exactness (oracle) or vectorisation (ML)."""
        n = len(times)
        feats = synth_event_telemetry(times, predictable, rack_corr, seed)
        out = np.zeros(n, bool)
        leads = np.zeros(n, np.float64)
        for j in range(n):
            if not np.isfinite(times[j]):
                continue  # batch padding
            frame = TelemetryFrame(
                t=float(times[j]),
                signals={-1: HealthSignal(node=-1, features=feats[j])},
            )
            for v in self.observe(float(times[j]), frame):
                if v.kind == "failure_predicted":
                    out[j] = True
                    leads[j] = max(leads[j], v.lead_s)
        return out, leads

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


def verdict_ledger(verdicts: Iterable[Verdict]) -> Dict[str, Dict[str, int]]:
    """Per-detector claim accounting over live-path verdicts.

    Groups a stream of :class:`Verdict` records (e.g. everything a
    :class:`~repro_torch.telemetry.builtin.CompositeDetector` emitted over a
    trainer run) by the claiming detector and tallies verdict kinds —
    the live-path sibling of the trace-derived
    :func:`repro_torch.obs.metrics.verdict_ledger`."""
    out: Dict[str, Dict[str, int]] = {}
    for v in verdicts:
        row = out.setdefault(v.detector, {k: 0 for k in VERDICT_KINDS})
        row[v.kind] = row.get(v.kind, 0) + 1
    return out
