"""Serving-traffic subsystem: arrival processes, SLO billing, autoscalers.

The fourth registry-backed axis (after strategies, detectors and
workloads): a :class:`~repro_torch.traffic.arrivals.TrafficSpec` describes
the offered request load over a campaign horizon, :func:`~repro_torch.traffic.
slo.bill_slo` prices one trial in p50/p99 latency / dropped-request /
availability terms — billed identically by the reference engine and the
batched replay fold — and registered :class:`~repro_torch.traffic.autoscale.
Autoscaler` policies decide how the fleet's capacity follows failures
and load. All of it is host numpy, as in the reference: the fold's
device work ends before billing starts.
"""
from repro_torch.traffic import registry
from repro_torch.traffic.arrivals import (
    ARRIVAL_STREAM,
    RequestTape,
    TrafficSpec,
    compile_request_tape,
)
from repro_torch.traffic.autoscale import Autoscaler, CapacityPlan
from repro_torch.traffic.registry import get, get_class, names, register, unregister
from repro_torch.traffic.slo import ServingTimeline, SloBill, bill_slo

__all__ = [
    "ARRIVAL_STREAM",
    "Autoscaler",
    "CapacityPlan",
    "RequestTape",
    "ServingTimeline",
    "SloBill",
    "TrafficSpec",
    "bill_slo",
    "compile_request_tape",
    "get",
    "get_class",
    "names",
    "register",
    "registry",
    "unregister",
]
