"""Unified telemetry & detection: frames in, verdicts out.

    from repro_torch.telemetry import TelemetryFrame, Verdict, registry

    det = registry.get("ml")
    verdicts = det.observe(t, frame)                 # live
    pred, lead = det.verdict_tape(spec, ...)         # compiled campaigns

The observation-side twin of ``repro_torch.strategies``: detectors are
registered once and immediately drivable by the scenario engine
(``CampaignEngine(spec, approach, detector="ml")``) and the batched
Monte-Carlo (``mc_trajectories(spec, strat, detector="ml")``).

:func:`resolve` is the one rule every ``detector=`` parameter follows: an
instance is used as given, a name is instantiated and placed on the
caller's device (the ``ml`` detector trains its predictor there).
"""
from repro_torch.telemetry import registry
from repro_torch.telemetry.builtin import (
    CompositeDetector,
    EWMAStragglerDetector,
    MLDetector,
    OracleDetector,
)
from repro_torch.telemetry.detector import VERDICT_KINDS, Detector, Verdict, verdict_ledger
from repro_torch.telemetry.frame import (
    RACK_DRIFT_STRESS,
    TRANSIENT_ALARM_RATE,
    HealthSignal,
    TelemetryFrame,
    frame_from_heartbeats,
    synth_event_telemetry,
)
from repro_torch.telemetry.registry import get, get_class, names, register, unregister


def resolve(detector, device="cuda") -> Detector:
    """An instance wins; a registered name (or alias) is instantiated with
    its ``device`` set to ``device``."""
    if isinstance(detector, Detector):
        return detector
    det = get(detector)
    det.device = str(device)
    return det


__all__ = [
    "CompositeDetector",
    "Detector",
    "EWMAStragglerDetector",
    "HealthSignal",
    "MLDetector",
    "OracleDetector",
    "RACK_DRIFT_STRESS",
    "TRANSIENT_ALARM_RATE",
    "TelemetryFrame",
    "VERDICT_KINDS",
    "Verdict",
    "frame_from_heartbeats",
    "get",
    "get_class",
    "names",
    "register",
    "registry",
    "resolve",
    "synth_event_telemetry",
    "unregister",
    "verdict_ledger",
]
