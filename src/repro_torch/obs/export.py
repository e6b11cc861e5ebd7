"""Chrome-trace / Perfetto export for campaign traces.

Serialises a :class:`~repro_torch.obs.trace.CampaignTrace` into the Chrome
Trace Event JSON format (the ``traceEvents`` array form), loadable in
``chrome://tracing`` or https://ui.perfetto.dev. Layout:

* one *process* per campaign, named ``scenario/approach seed=k``;
* one *thread track* per host (``node 0`` … ``node H-1``) plus a
  ``campaign`` track (tid 0) for node-less schedule events
  (``ckpt_write``, partition opens/heals);
* instant events (``ph="i"``) for failures, verdicts, migrations,
  blacklists, provisions, strands; duration spans (``ph="X"``) for
  degrade windows (start → ``until_s``) and for the billed campaign span
  itself; a ``nodes_up`` counter track (``ph="C"``) stepped from the
  availability timeline.

Timestamps are simulated-seconds × 1e6 (the format wants microseconds)
and the emitted array is sorted so timestamps are monotonic — the
round-trip property the obs tests assert."""
from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["to_chrome_trace", "write_chrome_trace"]

_PID = 1  # one campaign per export: a single process
_TID_CAMPAIGN = 0  # node-less schedule events


def _us(t_s: float) -> float:
    return float(t_s) * 1e6


def to_chrome_trace(trace) -> Dict:
    """Build the Chrome-trace dict (``{"traceEvents": [...], ...}``)."""
    from repro_torch.obs.metrics import availability_timeline

    evs: List[Dict] = []
    evs.append(
        {
            "ph": "M",
            "pid": _PID,
            "tid": _TID_CAMPAIGN,
            "ts": 0,
            "name": "process_name",
            "args": {"name": f"{trace.scenario}/{trace.approach} seed={trace.seed}"},
        }
    )
    evs.append(
        {
            "ph": "M",
            "pid": _PID,
            "tid": _TID_CAMPAIGN,
            "ts": 0,
            "name": "thread_name",
            "args": {"name": "campaign"},
        }
    )
    for h in range(trace.n_hosts):
        evs.append(
            {
                "ph": "M",
                "pid": _PID,
                "tid": h + 1,
                "ts": 0,
                "name": "thread_name",
                "args": {"name": f"node {h}"},
            }
        )

    # the billed campaign span: horizon when survived, cut at failed_at
    evs.append(
        {
            "ph": "X",
            "pid": _PID,
            "tid": _TID_CAMPAIGN,
            "ts": 0,
            "dur": _us(trace.end_s),
            "name": "campaign" if trace.survived else "campaign (lost)",
            "cat": "campaign",
            "args": {
                "survived": trace.survived,
                "detector": trace.detector,
                "workload": trace.workload,
                "source": trace.source,
            },
        }
    )

    for ev in trace.events:
        tid = ev.node + 1 if ev.node >= 0 else _TID_CAMPAIGN
        args = dict(ev.meta)
        if ev.node >= 0:
            args["node"] = ev.node
        if ev.target >= 0:
            args["target"] = ev.target
        row = {
            "pid": _PID,
            "tid": tid,
            "ts": _us(ev.t),
            "name": ev.kind,
            "cat": ev.kind,
            "args": args,
        }
        if ev.kind == "degrade":
            row["ph"] = "X"
            row["dur"] = max(_us(ev.arg("until_s", ev.t)) - _us(ev.t), 0.0)
        else:
            row["ph"] = "i"
            row["s"] = "t"  # thread-scoped instant
        evs.append(row)

    for t, frac in availability_timeline(trace):
        evs.append(
            {
                "ph": "C",
                "pid": _PID,
                "tid": _TID_CAMPAIGN,
                "ts": _us(t),
                "name": "nodes_up",
                "cat": "availability",
                "args": {"frac_up": round(frac, 4)},
            }
        )

    # monotonic timestamps (metadata rows first at equal ts)
    evs.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": {
            "scenario": trace.scenario,
            "approach": trace.approach,
            "seed": trace.seed,
            "detector": trace.detector,
            "workload": trace.workload,
            "source": trace.source,
            "survived": trace.survived,
            "horizon_s": trace.horizon_s,
        },
    }


def write_chrome_trace(trace, path: str) -> str:
    """Serialise ``trace`` to ``path`` (open the file in Perfetto /
    ``chrome://tracing``). Returns the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(trace), f)
    return path
