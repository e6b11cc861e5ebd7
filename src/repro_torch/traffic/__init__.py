"""Serving traffic: the arrival processes a scenario may declare.

Only :mod:`repro_torch.traffic.arrivals` is ported so far: a
:class:`~repro_torch.traffic.arrivals.TrafficSpec` is a field of every
:class:`~repro_torch.scenarios.spec.ScenarioSpec`. The SLO biller, the
autoscalers and their registry are a later slice (ROADMAP Queue 1, item
8); a campaign on a spec that declares traffic raises until then.
"""
from repro_torch.traffic.arrivals import (
    ARRIVAL_STREAM,
    RequestTape,
    TrafficSpec,
    compile_request_tape,
)

__all__ = [
    "ARRIVAL_STREAM",
    "RequestTape",
    "TrafficSpec",
    "compile_request_tape",
]
