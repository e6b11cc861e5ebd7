"""The built-in detector adapters.

``oracle``
    the regression anchor: reproduces the pre-refactor semantics
    bit-for-bit. On compiled tapes its verdicts ARE the ground-truth
    ``predictable`` bits; live, it reads the frame's ``oracle`` side
    channel (the trainer's imminence/false-alarm flags). It never looks
    at telemetry — swapping it out is how detection becomes *inferred*.

``ml``
    the paper's agent intelligence: wraps :class:`FailurePredictor`,
    scoring each node's latest health-log features. Predictability is
    inferred per event from the generative logs — coverage is bounded by
    the 29 % of failures that emit a degrading signature at all, and
    transient alarms on healthy nodes put operating precision in the
    paper's ~64 % band.

``ewma_straggler``
    wraps :class:`~repro_torch.core.straggler.StragglerDetector`: EWMA +
    variance of per-host step latencies, flagging hosts whose z-score
    drifts. Emits ``straggler`` verdicts (performance degradation as a
    sensing problem, Roy et al. 1005.2027); it predicts no failures.

:class:`CompositeDetector` fans one frame out to several detectors and
concatenates their verdicts (the trainer runs ``<failure detector> +
ewma_straggler`` so mobility serves faults and stragglers alike).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.failure import PREDICTION_LEAD_S
from repro_torch.core.straggler import StragglerDetector
from repro_torch.telemetry.detector import Detector, Verdict
from repro_torch.telemetry.frame import TelemetryFrame, synth_event_telemetry
from repro_torch.telemetry.registry import register


@lru_cache(maxsize=8)
def _trained_predictor(seed: int, device: str):
    """One trained FailurePredictor per (seed, device): training runs a few
    hundred SGD epochs, far too slow to repeat per campaign."""
    from repro_torch.core.predictor import FailurePredictor

    return FailurePredictor.train(seed=seed, device=device)


@register("oracle")
class OracleDetector(Detector):
    """Ground-truth passthrough — the pre-refactor ``ev.predictable``
    branch expressed as a detector, and the bit-for-bit regression anchor
    for every campaign record and Table CSV."""

    def observe(self, t: float, frame: TelemetryFrame) -> List[Verdict]:
        o = frame.oracle
        if not o:
            return []
        out = []
        if o.get("imminent"):
            out.append(
                Verdict(
                    node=int(o.get("node", -1)),
                    kind="failure_predicted",
                    confidence=1.0,
                    lead_s=float(o.get("lead_s", PREDICTION_LEAD_S)),
                    detector=self.name,
                )
            )
        elif o.get("false_alarm"):
            out.append(
                Verdict(
                    node=int(o.get("node", -1)),
                    kind="failure_predicted",
                    confidence=0.5,
                    lead_s=0.0,
                    detector=self.name,
                )
            )
        return out

    def verdict_tape(self, spec, times, predictable, rack_corr, seed):
        pred = np.asarray(predictable, bool).copy()
        leads = np.where(pred, PREDICTION_LEAD_S, 0.0)
        return pred, leads


@register("ml", aliases=("predictor",))
class MLDetector(Detector):
    """Inference: the node's health log scored by the logistic-hazard
    :class:`FailurePredictor`. ``predictor`` may be injected (the trainer
    shares its runtime's); otherwise one is trained (and cached) for
    ``train_seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, predictor=None, train_seed: int = 0, device: str = "cuda"):
        self.predictor = predictor
        self.train_seed = int(train_seed)
        self.device = str(device)

    def bind(self, rt) -> "MLDetector":
        if self.predictor is None and getattr(rt, "predictor", None) is not None:
            self.predictor = rt.predictor
        return self

    def _ensure_predictor(self):
        if self.predictor is None:
            self.predictor = _trained_predictor(self.train_seed, self.device)
        return self.predictor

    def observe(self, t: float, frame: TelemetryFrame) -> List[Verdict]:
        if not frame.signals:
            return []
        p = self._ensure_predictor()
        nodes = sorted(frame.signals)
        # one batched sigmoid for the whole frame, not one dispatch
        # per node (this runs in the trainer's per-step hot loop)
        scores = p.score_many(
            np.stack([frame.signals[n].features for n in nodes])
        )
        return [
            Verdict(
                node=n,
                kind="failure_predicted",
                confidence=float(s),
                lead_s=float(PREDICTION_LEAD_S * s),
                detector=self.name,
            )
            for n, s in zip(nodes, scores)
            if s >= p.threshold
        ]

    def verdict_tape(self, spec, times, predictable, rack_corr, seed):
        # vectorised over slots: one batched sigmoid instead of one
        # dispatch per event (the per-slot feature draws stay identical to
        # the default observe() path — same slot-keyed rng)
        p = self._ensure_predictor()
        feats = synth_event_telemetry(times, predictable, rack_corr, seed)
        scores = p.score_many(feats)
        pred = (scores >= p.threshold) & np.isfinite(np.asarray(times))
        leads = np.where(pred, PREDICTION_LEAD_S * scores, 0.0)
        return pred, leads


@register("ewma_straggler")
class EWMAStragglerDetector(Detector):
    """Performance sensing: flags hosts whose step-latency EWMA z-score
    exceeds the threshold. Emits ``straggler`` verdicts only — campaigns
    run under it mitigate ``degrade`` windows but treat every failure as
    blind (no ``failure_predicted`` claims)."""

    flags_stragglers = True

    def __init__(self, n_hosts: int = 0, **cfg):
        self._cfg = cfg
        self._det: Optional[StragglerDetector] = None
        if n_hosts:
            self._det = StragglerDetector(n_hosts=n_hosts, **cfg)

    def observe(self, t: float, frame: TelemetryFrame) -> List[Verdict]:
        lat = frame.step_latency_s
        if lat is None:
            return []
        lat = np.asarray(lat, dtype=float)
        if self._det is None or self._det.n_hosts != len(lat):
            self._det = StragglerDetector(n_hosts=len(lat), **self._cfg)
        flagged = self._det.observe(lat)
        pool_mu = float(np.median(self._det.mean))
        return [
            Verdict(
                node=int(i),
                kind="straggler",
                confidence=float(
                    min(1.0, self._det.mean[i] / max(pool_mu, 1e-9) - 1.0)
                ),
                detector=self.name,
            )
            for i in flagged
        ]

    def verdict_tape(self, spec, times, predictable, rack_corr, seed):
        n = len(times)
        return np.zeros(n, bool), np.zeros(n, np.float64)


class CompositeDetector(Detector):
    """Fan one frame out to several detectors; verdicts concatenate in
    member order. ``flags_stragglers`` is true if any member flags."""

    name = "composite"

    def __init__(self, members: Sequence[Detector]):
        self.members: Tuple[Detector, ...] = tuple(members)
        self.flags_stragglers = any(m.flags_stragglers for m in self.members)

    def bind(self, rt) -> "CompositeDetector":
        for m in self.members:
            m.bind(rt)
        return self

    def observe(self, t: float, frame: TelemetryFrame) -> List[Verdict]:
        out: List[Verdict] = []
        for m in self.members:
            out.extend(m.observe(t, frame))
        return out

    def verdict_tape(self, spec, times, predictable, rack_corr, seed):
        pred = np.zeros(len(times), bool)
        leads = np.zeros(len(times), np.float64)
        for m in self.members:
            p, l = m.verdict_tape(spec, times, predictable, rack_corr, seed)
            pred |= p
            leads = np.maximum(leads, l)
        return pred, leads
