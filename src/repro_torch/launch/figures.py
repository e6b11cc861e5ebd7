"""The paper's Figures 8-13: reinstate time against the number of
dependencies Z, the data size S_d and the process size S_p, priced by the
port.

  PYTHONPATH=src python -m repro_torch.launch.figures [--trials 30] [--json]
      [--out DIR] [--device cuda]

The counterpart of ``benchmarks/bench_dependencies.py`` (Figs 8-9),
``bench_datasize.py`` (Figs 10-11) and ``bench_process_size.py`` (Figs
12-13) over ``benchmarks/common.py::reinstate_trials``: the same sweeps,
row dicts, rounding and the same 10 paper-claim checks (5, 3 and 2). Each
point is the mean of ``--trials`` real migrations (30, as in the paper)
of a sub-job by an agent (``agent``), a virtual core (``core``) or an
agent that re-establishes its Z dependencies in one grouped exchange
(``agent_batched``, beyond the paper; Figs 8-9 only), on the four
cluster profiles.

The migrated payload (``{"partial": ..., "cursor": t}``) lies on
``--device``: a float32 tensor on the card unless ``--device cpu``, where
it is the reference's numpy array. Reinstate time is a measured part (the
real dependency surgery, by wall clock) plus a modelled part; the
metadata term of the modelled part is priced from the pickled payload's
length, which differs between a tensor and an array, so each trial
swaps the measured payload's term for the experiment's S_p term, as the
reference does. With the numpy payload the modelled terms and the
staging overhead are bitwise the reference's.

Writes ``fig8_9_dependencies.csv``, ``fig10_11_datasize.csv`` and
``fig12_13_process_size.csv`` to ``--out`` (default ``$BENCH_OUT``, else
``bench_out_torch/``). Prints one PASS/FAIL line per check; ``--json``
makes the last line one JSON object. Exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.launch.tables import write_csv
from repro_torch.utils.device import resolve_device

CLUSTERS = ["acet", "brasdor", "glooscap", "placentia"]
# Figs 8-9: Z = 3..63 at S_d = 2^24 KB
ZS = [3, 5, 10, 15, 20, 25, 30, 40, 50, 63]
S_D = (2 ** 24) * 1024
# Figs 10-11 and 12-13: S = 2^n KB at Z = 10
NS_DATASIZE = [19, 21, 23, 24, 25, 27, 29, 31]
NS_PROCESS_SIZE = [19, 21, 23, 24, 25, 26, 27, 29, 31]


def reinstate_trials(
    mechanism: str,
    profile: str,
    z: int,
    s_d_bytes: int,
    s_p_bytes: int,
    trials: int = 30,
    payload_elems: int = 1 << 14,
    device="cuda",
):
    """Mean/std reinstate time over ``trials`` REAL migrations (paper: mean
    of 30 trials), and the mean staging overhead of S_d bytes. The
    in-process payload is a stand-in placed on ``device``; the modelled
    metadata term is scaled to the experiment's S_p (see
    ``core.sim.measure_micro``)."""
    import torch

    from repro_torch.core.agent import Agent
    from repro_torch.core.cluster import get_profile
    from repro_torch.core.migration import META_LOG_COEF, DependencyGraph
    from repro_torch.core.runtime import ClusterRuntime
    from repro_torch.core.virtual_core import VirtualCore

    dev = resolve_device(device)
    prof = get_profile(profile)
    speed = max(prof.node_speed, 0.1)
    times = []
    staging = []
    for t in range(trials):
        rt = ClusterRuntime(n_hosts=8, n_spares=2, profile=profile, seed=t)
        g = DependencyGraph()
        for e in range(z):  # exactly Z edges on node 0
            peer = 1 + (e % 6)
            if e % 2 == 0:
                g.in_edges.setdefault(0, []).append(peer)
                g.out_edges.setdefault(peer, []).append(0)
            else:
                g.out_edges.setdefault(0, []).append(peer)
                g.in_edges.setdefault(peer, []).append(0)
        rt.graph = g
        if dev.type == "cpu":
            partial = np.zeros(payload_elems, np.float32)
        else:
            partial = torch.zeros(payload_elems, dtype=torch.float32, device=dev)
        payload = {"partial": partial, "cursor": t}
        rt.occupy(0, payload, "bench")
        if mechanism == "agent":
            rep = Agent(0, 0, payload).migrate(rt)
        elif mechanism == "agent_batched":
            rep = Agent(0, 0, payload).migrate(rt, batched_deps=True)
        else:
            rep = VirtualCore(0, 0).migrate_job(rt)
        if not rep["hash_ok"]:
            raise RuntimeError(f"{mechanism} on {profile}: the migrated payload's hash differs")
        meta_measured = META_LOG_COEF * np.log2(max(rep["bytes"], 2)) / speed
        meta_target = META_LOG_COEF * np.log2(max(s_p_bytes, 2)) / speed
        times.append(rep["reinstate_s"] - meta_measured + meta_target)
        staging.append(s_d_bytes / prof.node_bw + s_d_bytes / prof.ser_bytes_per_s)
    return float(np.mean(times)), float(np.std(times)), float(np.mean(staging))


def dependencies(out_dir: str, trials: int = 30, device="cuda"):
    """Figs 8-9 (``bench_dependencies.run``): reinstate time against Z,
    agent vs core vs agent_batched, S_d fixed at 2^24 KB."""
    rows = []
    for mech in ("agent", "core", "agent_batched"):
        for cl in CLUSTERS:
            for z in ZS:
                mean, std, _ = reinstate_trials(mech, cl, z, S_D, S_D, trials, device=device)
                rows.append(
                    dict(mechanism=mech, cluster=cl, Z=z,
                         reinstate_mean_s=round(mean, 5), reinstate_std_s=round(std, 5))
                )
    path = write_csv(out_dir, "fig8_9_dependencies.csv", rows)

    # paper-claim checks (Rule 1 region & magnitude)
    at = {(r["mechanism"], r["cluster"], r["Z"]): r["reinstate_mean_s"] for r in rows}
    checks = {
        "core_beats_agent_at_Z<=10_placentia": all(
            at[("core", "placentia", z)] < at[("agent", "placentia", z)] for z in (3, 5, 10)
        ),
        "agent_Z50_under_0.55s_placentia": at[("agent", "placentia", 50)] < 0.55,
        "core_Z50_under_0.5s_placentia": at[("core", "placentia", 50)] < 0.5,
        "acet_slowest_for_agent": all(
            at[("agent", "acet", z)] >= max(at[("agent", c, z)] for c in CLUSTERS[1:])
            for z in (10, 50)
        ),
        "batched_flat_in_Z": (at[("agent_batched", "placentia", 63)]
                              - at[("agent_batched", "placentia", 3)]) < 0.02,
    }
    return path, rows, checks


def datasize(out_dir: str, trials: int = 30, device="cuda"):
    """Figs 10-11 (``bench_datasize.run``): reinstate time against S_d =
    2^n KB, n = 19..31, agent vs core, Z = 10."""
    rows = []
    for mech in ("agent", "core"):
        for cl in CLUSTERS:
            for n in NS_DATASIZE:
                sd = (2 ** n) * 1024
                mean, std, staging = reinstate_trials(mech, cl, 10, sd, sd, trials, device=device)
                rows.append(
                    dict(mechanism=mech, cluster=cl, n=n, s_d_bytes=sd,
                         reinstate_mean_s=round(mean, 5),
                         reinstate_std_s=round(std, 5),
                         staging_overhead_s=round(staging, 3))
                )
    path = write_csv(out_dir, "fig10_11_datasize.csv", rows)
    at = {(r["mechanism"], r["cluster"], r["n"]): r["reinstate_mean_s"] for r in rows}
    checks = {
        # Rule 2 region: agent <= core for S_d <= 2^24 KB
        "agent_beats_core_small_Sd_placentia": all(
            at[("agent", "placentia", n)] <= at[("core", "placentia", n)] + 0.12
            for n in (19, 21, 23, 24)
        ),
        "reinstate_sub_second_placentia": all(
            at[(m, "placentia", n)] < 1.0 for m in ("agent", "core") for n in NS_DATASIZE
        ),
        "mild_growth_with_Sd": (at[("agent", "placentia", 31)]
                                - at[("agent", "placentia", 19)]) < 0.2,
    }
    return path, rows, checks


def process_size(out_dir: str, trials: int = 30, device="cuda"):
    """Figs 12-13 (``bench_process_size.run``): reinstate time against S_p
    = 2^n KB (proportional to input data), agent vs core, Z = 10."""
    rows = []
    for mech in ("agent", "core"):
        for cl in CLUSTERS:
            for n in NS_PROCESS_SIZE:
                sp = (2 ** n) * 1024
                mean, std, _ = reinstate_trials(mech, cl, 10, sp, sp, trials, device=device)
                rows.append(
                    dict(mechanism=mech, cluster=cl, n=n, s_p_bytes=sp,
                         reinstate_mean_s=round(mean, 5), reinstate_std_s=round(std, 5))
                )
    path = write_csv(out_dir, "fig12_13_process_size.csv", rows)
    at = {(r["mechanism"], r["cluster"], r["n"]): r["reinstate_mean_s"] for r in rows}
    checks = {
        # Rule 3 region
        "agent_beats_core_small_Sp_placentia": all(
            at[("agent", "placentia", n)] <= at[("core", "placentia", n)] + 0.12
            for n in (19, 23, 24)
        ),
        "placentia_best_large_Sp": all(
            at[("core", "placentia", n)] <= min(at[("core", c, n)] for c in CLUSTERS[:3])
            for n in (27, 29, 31)
        ),
    }
    return path, rows, checks


SWEEPS = (("dependencies", dependencies), ("datasize", datasize),
          ("process_size", process_size))


def run(out_dir: Optional[str] = None, trials: int = 30, device="cuda") -> Dict:
    """The three sweeps; their rows, checks and each sweep's wall seconds."""
    out_dir = out_dir or os.environ.get("BENCH_OUT", "bench_out_torch")
    dev = resolve_device(device)
    res = {"device": str(dev), "trials": trials, "paths": [], "rows": {}, "checks": {},
           "seconds": {}}
    for name, sweep in SWEEPS:
        t0 = time.perf_counter()
        path, rows, checks = sweep(out_dir, trials, dev)
        res["seconds"][name] = time.perf_counter() - t0
        res["paths"].append(path)
        res["rows"][name] = rows
        res["checks"].update(checks)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=30, help="migrations per point (paper: 30)")
    ap.add_argument("--out", default=None, help="output directory (default $BENCH_OUT or "
                    "bench_out_torch/)")
    ap.add_argument("--device", default="cuda", help="where the payload lies: cuda or cpu")
    ap.add_argument("--json", action="store_true", help="last line: one JSON object")
    args = ap.parse_args(argv)
    res = run(args.out, args.trials, args.device)
    for path in res["paths"]:
        print(path)
    for k, v in res["checks"].items():
        print(f"  {k}: {'PASS' if v else 'FAIL'}")
    print(f"figures: {args.trials} trials a point on {res['device']}: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res["seconds"].items()))
    ok = all(res["checks"].values())
    if args.json:
        print(json.dumps({k: res[k] for k in ("device", "trials", "checks", "seconds", "rows")}
                         | {"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
