"""The unified telemetry data model: everything a detector may observe.

One frame per observation instant bundles the three health-signal sources
the repo previously handed to three different consumers ad hoc:

  * per-node **health-log features** — the generative 6-feature vectors
    ``HeartbeatService.tick()`` appends to each node's local log (the
    paper's per-node health log mined by each agent's ML component);
  * **rack stress** — the fraction of a node's rack peers currently
    degrading or failed (shared PSU/cooling domain,
    ``HeartbeatService.rack_stress``);
  * **per-host step latencies** — the synchronous-step pacing signal the
    straggler detector watches (``latency_ewma`` or real step timings).

Detectors consume frames through ``Detector.observe(t, frame)`` and emit
:class:`~repro_torch.telemetry.detector.Verdict` records; no detector ever
reaches into the runtime directly.

``synth_event_telemetry`` is the *campaign-time* generative model: for a
compiled trajectory tape it draws, per event slot, the health-log features
the victim's agent would see at the failure instant — degrading signatures
for the ground-truth-predictable events, transient alarms on healthy nodes
at the paper's operating base rate, and correlated drift on rack-outage
events. Draws are keyed per slot (``(seed, salt, slot)``) so the Python
engine and the padded batch compiler produce bit-identical prefixes
regardless of padding length.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.heartbeat import N_FEATURES, HeartbeatService, TelemetryModel

# Campaign-context operating point. In a campaign every observed event IS a
# real failure, so precision = p / (p + (1-p)·r) with p = 0.29 the
# predictable (signal-emitting) fraction and r the transient-alarm rate on
# nodes that die without warning. r = 0.23 puts the ML detector at the
# paper's ~64 % precision: 0.29 / (0.29 + 0.71·0.23) ≈ 0.64.
TRANSIENT_ALARM_RATE = 0.23
# Correlated drift applied to a healthy node's telemetry during a rack
# outage (fraction of rack peers already degrading/failed it perceives).
RACK_DRIFT_STRESS = 0.35

_SLOT_SALT = 0x7E1E


@dataclass
class HealthSignal:
    """One node's latest health-log entry as a detector sees it."""

    node: int
    features: np.ndarray  # the 6-feature heartbeat log vector
    rack_stress: float = 0.0


@dataclass
class TelemetryFrame:
    """Everything observable at one instant ``t``.

    ``oracle`` is the ground-truth side channel the :class:`OracleDetector`
    regression anchor reads (the pre-refactor ``ev.predictable`` bit /
    trainer imminence flags); inference detectors must ignore it."""

    t: float
    signals: Dict[int, HealthSignal] = field(default_factory=dict)
    step_latency_s: Optional[np.ndarray] = None  # per-host pacing signal, seconds
    oracle: Optional[Dict] = None  # ground truth: OracleDetector only

    def feature_matrix(self) -> np.ndarray:
        """Stacked ``[n, N_FEATURES]`` features in node order."""
        if not self.signals:
            return np.zeros((0, N_FEATURES), np.float32)
        return np.stack([self.signals[n].features for n in sorted(self.signals)])


def frame_from_heartbeats(
    hb: HeartbeatService,
    t: float,
    features: Optional[Dict[int, np.ndarray]] = None,
    step_latency_s: Optional[np.ndarray] = None,
    oracle: Optional[Dict] = None,
) -> TelemetryFrame:
    """Build a frame from a live :class:`HeartbeatService`.

    ``features`` is the return of the ``tick()`` the caller just drove
    (the service is caller-clocked); when omitted, each node's latest
    logged entry is used instead."""
    signals: Dict[int, HealthSignal] = {}
    if features is None:
        # latest entries of LIVE nodes only — failed nodes keep their last
        # pre-death log entry, which must not resurface as a prediction
        features = {i: log[-1] for i, log in hb.logs.items() if log and hb.alive(i)}
    for i, f in features.items():
        signals[i] = HealthSignal(node=i, features=f, rack_stress=hb.rack_stress(i))
    if step_latency_s is None:
        step_latency_s = np.asarray(hb.latency_ewma, dtype=float)
    return TelemetryFrame(t=t, signals=signals, step_latency_s=step_latency_s, oracle=oracle)


def synth_event_telemetry(
    times: np.ndarray,
    predictable: np.ndarray,
    rack_corr: np.ndarray,
    seed: int,
    transient_rate: float = TRANSIENT_ALARM_RATE,
    rack_stress: float = RACK_DRIFT_STRESS,
) -> np.ndarray:
    """Per-slot victim health-log features for a compiled trajectory tape.

    Slot ``j`` draws from an rng keyed ``(seed, salt, j)`` — independent
    per slot, so a padded batch row and the engine's unpadded tape agree
    on every real slot. Ground-truth-predictable events sample the
    degrading profile (the node emitted a signature); unpredictable events
    sample healthy, except for transient alarms (rate ``transient_rate``,
    the paper's ~64 % precision base rate) and correlated rack drift on
    ``rack_corr`` slots. Padding slots (``t = inf``) are left zero."""
    n = len(times)
    feats = np.zeros((n, N_FEATURES), np.float32)
    for j in range(n):
        if not np.isfinite(times[j]):
            continue  # batch padding: never observed
        tm = TelemetryModel((int(seed), _SLOT_SALT, j))
        if bool(predictable[j]):
            feats[j] = tm.sample("degrading")
        else:
            noisy = tm.rng.random() < transient_rate
            stress = rack_stress if bool(rack_corr[j]) else 0.0
            feats[j] = tm.sample("degrading" if noisy else "healthy", rack_stress=stress)
    return feats
