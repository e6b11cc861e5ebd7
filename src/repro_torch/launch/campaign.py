"""Fault-tolerance campaigns: the paper's job under streams of failures,
Monte-Carlo'd over seeds by the replay fold on the card.

  PYTHONPATH=src python -m repro_torch.launch.campaign [--scenario flaky_node|all]
      [--strategy hybrid|all] [--seeds 256] [--detector oracle] [--workload NAME]
      [--tile-slots 8] [--check-seeds 4] [--device cuda] [--json]

For each scenario family and strategy asked for:

1. the family's tapes for ``--seeds`` seeds are compiled on the host
   (numpy, the reference's draws);
2. ``mc_trajectories`` replays every seed at once on ``--device`` (the
   card unless ``--device cpu``) and summarises survival, mean and
   p5/p50/p95 totals and the metric frames;
3. the first ``--check-seeds`` trials are run again one at a time through
   ``CampaignEngine`` and must equal the replay: counters exactly, costs
   within ``rel=1e-9, abs=1e-6``, totals within ``rel=1e-9`` and failure
   times within ``rel=1e-12`` (the tolerances of the reference's
   ``tests/test_trajectory.py``).

Prints the replay's seconds and seeds/s and the engine's seconds per
trial. ``--scenario all`` runs every registered family whose workload the
port has; ``llm_pretrain_storm`` and ``decode_fleet_churn`` price through
the LLM workloads and SLO billing (ROADMAP Queue 1, item 8): asked for by
name they raise, and ``all`` lists them as waiting. ``--json`` makes the
last line one JSON object. Exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.scenarios import registry as scenarios
from repro_torch.scenarios.engine import CampaignEngine
from repro_torch.scenarios.montecarlo import mc_trajectories
from repro_torch.scenarios.trajectory import compile_batch
from repro_torch.strategies import registry as strategies
from repro_torch.utils.device import resolve_device
from repro_torch.workloads import registry as workloads

COUNTERS = ("n_events", "n_handled", "n_migrations", "n_blacklisted", "n_reprovisioned")
COSTS = ("lost_s", "reinstate_s", "overhead_s", "probe_s")


def _close(got: float, want: float, rel: float, abs_: float = 1e-12) -> bool:
    """``got == pytest.approx(want, rel=rel, abs=abs_)``."""
    return abs(got - want) <= max(rel * abs(want), abs_)


def trial_mismatches(out: Dict[str, np.ndarray], k: int, res) -> List[str]:
    """The fields where replay trial ``k`` differs from the engine's
    :class:`CampaignResult` ``res`` beyond the reference tests' tolerances
    (empty when they agree)."""
    bad = []
    if bool(out["survived"][k]) != res.survived:
        return ["survived"]
    bad += [f for f in COUNTERS if int(out[f][k]) != getattr(res, f)]
    bad += [f for f in COSTS if not _close(float(out[f][k]), getattr(res, f), 1e-9, 1e-6)]
    if res.survived:
        if not _close(float(out["total_s"][k]), res.total_s, 1e-9):
            bad.append("total_s")
        if not math.isnan(out["failed_at_s"][k]):
            bad.append("failed_at_s")
    else:
        if not math.isnan(out["total_s"][k]):
            bad.append("total_s")
        if not _close(float(out["failed_at_s"][k]), res.failed_at_s, 1e-12):
            bad.append("failed_at_s")
    return bad


def runnable_families() -> List[str]:
    """Registered families whose workload the port has and that declare
    no traffic (the others wait for ROADMAP Queue 1, item 8)."""
    have = set(workloads.names())
    return [n for n in scenarios.names()
            if scenarios.get(n).workload in have and scenarios.get(n).traffic is None]


def run_one(family: str, strategy: str, n_seeds: int, *, detector="oracle", workload=None,
            tile_slots: int = 8, check_seeds: int = 4, device="cuda") -> Dict:
    """One (family, strategy) cell: the replay over seeds ``0 .. n_seeds - 1``
    on ``device`` and its check against the first ``check_seeds`` of them
    run through the engine."""
    dev = resolve_device(device)
    spec = scenarios.get(family)
    t0 = time.perf_counter()
    batch = compile_batch(spec, n_seeds)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mc = mc_trajectories(spec, strategy, n_seeds, batch=batch, detector=detector,
                         workload=workload, tile_slots=tile_slots, device=str(dev))
    replay_s = time.perf_counter() - t0  # the trials are numpy on the host: the fold is done
    out = mc.pop("trials")
    mismatches = {}
    t0 = time.perf_counter()
    n_check = min(check_seeds, n_seeds)
    for k in range(n_check):
        res = CampaignEngine(spec, strategy, seed=k, detector=detector,
                             workload=workload, device=str(dev)).run()
        bad = trial_mismatches(out, k, res)
        if bad:
            mismatches[k] = bad
    engine_s = time.perf_counter() - t0
    return {
        "scenario": family,
        "strategy": strategies.get_class(strategy).name,
        "device": str(dev),
        "n_seeds": n_seeds,
        "n_hosts": batch.n_hosts,
        "n_slots": batch.n_slots,
        "survival_rate": mc["survival_rate"],
        "mean_s": mc["mean_s"],
        "p5_s": mc["p5_s"],
        "p50_s": mc["p50_s"],
        "p95_s": mc["p95_s"],
        "counters": mc["counters"],
        "frames": mc["frames"],
        "compile_s": compile_s,
        "replay_s": replay_s,
        "seeds_per_s": n_seeds / replay_s,
        "checked": n_check,
        "engine_s_per_trial": engine_s / n_check if n_check else None,
        "mismatches": mismatches,
        "ok": not mismatches,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="flaky_node", help="a registered family, or 'all'")
    ap.add_argument("--strategy", default="hybrid", help="a registered strategy, or 'all'")
    ap.add_argument("--seeds", type=int, default=256, help="trials replayed per cell")
    ap.add_argument("--detector", default="oracle", help="registered detector deciding predictions")
    ap.add_argument("--workload", default=None,
                    help="registered workload billing the trials (default: the family's)")
    ap.add_argument("--tile-slots", type=int, default=8, help="slots staged onto the device at a time")
    ap.add_argument("--check-seeds", type=int, default=4,
                    help="trials checked against CampaignEngine per cell")
    ap.add_argument("--device", default="cuda", help="where the replay runs: cuda or cpu")
    ap.add_argument("--json", action="store_true", help="last line: one JSON object")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises before any work without a card

    waiting: List[str] = []
    if args.scenario == "all":
        families = runnable_families()
        waiting = [n for n in scenarios.names() if n not in families]
    else:
        families = [args.scenario]
    names = strategies.names() if args.strategy == "all" else [args.strategy]

    cells = []
    for family in families:
        for name in names:
            r = run_one(family, name, args.seeds, detector=args.detector, workload=args.workload,
                        tile_slots=args.tile_slots, check_seeds=args.check_seeds,
                        device=args.device)
            cells.append(r)
            print(f"{family:18s} {r['strategy']:15s} {r['n_seeds']} seeds x {r['n_hosts']} hosts x "
                  f"{r['n_slots']} slots on {r['device']}: survival {r['survival_rate']:.3f}, "
                  f"mean {r['mean_s']:.6f} s, p5/p50/p95 {r['p5_s']:.3f}/{r['p50_s']:.3f}/"
                  f"{r['p95_s']:.3f} s; replay {r['replay_s']:.4f} s ({r['seeds_per_s']:.1f} "
                  f"seeds/s); engine {r['engine_s_per_trial']:.4f} s/trial; {r['checked']} "
                  f"trials checked: {'equal' if r['ok'] else r['mismatches']}")
    if waiting:
        print(f"waiting for the LLM workloads and SLO billing (ROADMAP Queue 1, item 8): "
              f"{', '.join(waiting)}")
    ok = all(r["ok"] for r in cells)
    print("OK" if ok else "FAIL")
    if args.json:
        print(json.dumps({"cells": cells, "waiting": waiting, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
