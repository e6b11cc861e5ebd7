"""The paper's validation job: parallel genome pattern searching with
multi-agent fault tolerance (paper §Genome searching), searched on the card.

  PYTHONPATH=src python -m repro_torch.launch.genome [--genome-mb 0.25] [--patterns 24]
      [--strategy hybrid|all|<name>] [--campaign] [--device cuda] [--json]

The live part of ``examples/genome_search.py``: three search sub-jobs and
one combiner (Z = 4, the paper's setup), driven through the registries.

1. a failure-free reference run of the job;
2. for each strategy asked for, a run with the strategy attached to the
   cluster runtime, the REAL sub-job states as payloads, micro-costs from
   ``measure_micro("placentia", n_nodes=4)``;
3. a predicted failure on node 0 after its first chunk, routed through
   ``on_prediction``: the strategy migrates the live sub-job state;
4. checks: each run's combined hit table is identical to the reference
   run's, and every planted pattern occurrence is found;
5. with ``--campaign``, the example's campaign section: the registered
   ``genome_campaign`` scenario (the paper's five-hour job under random and
   rack failures) priced by ``CampaignEngine`` under each strategy asked
   for, billed with the ``genome_search`` workload (its search timed on
   ``--device``); checks that checkpointing (``central_single``) costs more
   than every multi-agent strategy run (``agent``, ``core``, ``hybrid``).

The genome search runs on ``--device`` (the card unless ``--device cpu``).
``--json`` makes the last line one JSON object. Exits 1 when a check
fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.failure import FailureEvent
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.rules import decide
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.sim import fmt_hms, measure_micro
from repro_torch.data.genome import GenomeSearchJob, make_genome
from repro_torch.strategies import registry as strategies
from repro_torch.utils.device import resolve_device, synchronize


def _search_all(job: GenomeSearchJob, states: List[Dict]) -> None:
    for st in states:
        while job.run_sub_job_step(st):
            pass


def ft_run(job: GenomeSearchJob, strategy: str, micro) -> Dict:
    """One FT run: attach ``strategy``, search node 0's first chunk, migrate
    node 0 on a predicted failure, finish the search."""
    rt = ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia",
                        graph=DependencyGraph.star(3))
    states = job.sub_job_states()
    strat = strategies.get(strategy)
    strat.attach(rt, dict(enumerate(states)), micro=micro)
    job.run_sub_job_step(states[0])
    z = rt.graph.degree(0) + 1
    dec = decide(z, job.genome.nbytes, job.genome.nbytes)

    ev = FailureEvent(t=900.0, node=0, predictable=True)
    out = strat.on_prediction(ev, strat.pick_target(0, require_free=True))
    rep = out.report
    states[0] = rt.hosts[out.new_host].shard
    _search_all(job, states)
    return {
        "strategy": strat.name,
        "rules": f"Z={z}, S_d={job.genome.nbytes}B -> {dec.mechanism} ({dec.rule})",
        "from": rep.get("from", 0),
        "to": out.new_host,
        "mechanism": out.mechanism or rep.get("kind", "checkpoint"),
        "outcome": out.outcome,
        "reinstate_s": rep.get("reinstate_s", out.reinstate_s),
        "hash_ok": rep.get("hash_ok", True),
        "hits": job.combine(states),
    }


MULTI_AGENT = ("agent", "core", "hybrid")


def campaign(strategy_names: Sequence[str], device="cuda") -> Dict:
    """``genome_campaign`` (seed 0) through ``CampaignEngine`` under each
    strategy, billed with the ``genome_search`` workload calibrated on
    ``device``: total, overhead over the horizon, migrations per
    strategy, and whether checkpointing costs more than every multi-agent
    strategy in the run."""
    from repro_torch.scenarios import registry as scenarios
    from repro_torch.scenarios.engine import CampaignEngine
    from repro_torch.workloads import resolve as resolve_workload

    dev = resolve_device(device)
    spec = scenarios.get("genome_campaign")
    wl = resolve_workload("genome_search", spec, device=dev)
    rows = []
    for name in strategy_names:
        t0 = time.perf_counter()
        res = CampaignEngine(spec, name, workload=wl, device=str(dev)).run()
        rows.append({
            "strategy": res.approach, "survived": res.survived, "total_s": res.total_s,
            "overhead_pct": (100.0 * (res.total_s - spec.horizon_s) / spec.horizon_s
                             if res.survived else None),
            "migrations": res.n_migrations, "seconds": time.perf_counter() - t0,
        })
    ovh = {r["strategy"]: r["overhead_pct"] for r in rows}
    agents = [ovh[k] for k in MULTI_AGENT if ovh.get(k) is not None]
    ordering = ovh.get("central_single") is None or not agents or \
        ovh["central_single"] > max(agents)
    return {"scenario": spec.name, "description": spec.description, "workload": wl.name,
            "horizon_s": spec.horizon_s, "rows": rows,
            "ok": ordering and all(r["survived"] for r in rows)}


def run(bases: int, n_patterns: int = 24, strategy_names: Sequence[str] = ("hybrid",),
        device="cuda") -> Dict:
    """The job at ``bases`` bases with ``n_patterns`` planted patterns of
    15-25 bases (``make_genome(..., seed=7)``, the example's), searched on
    ``device``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    genome, patterns, truth = make_genome(bases, n_patterns=n_patterns, seed=7)
    make_s = time.perf_counter() - t0
    job = GenomeSearchJob(genome, patterns, n_search=3, device=str(dev))

    t0 = time.perf_counter()
    job.upload()
    synchronize(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    states = job.sub_job_states()
    _search_all(job, states)
    want = job.combine(states)
    search_s = time.perf_counter() - t0  # hits are on the host: the search is done

    micro = measure_micro("placentia", n_nodes=4)
    runs = []
    for name in strategy_names:
        t0 = time.perf_counter()
        r = ft_run(job, name, micro)
        r["seconds"] = time.perf_counter() - t0
        r["identical"] = r.pop("hits") == want
        runs.append(r)
    found = {(h[1], h[3], h[4]) for h in want}
    missing = sorted(t for t in truth if t not in found)
    return {
        "device": str(dev),
        "bases": bases,
        "patterns": n_patterns,
        "n_hits": len(want),
        "truth": len(truth),
        "missing": len(missing),
        "make_s": make_s,
        "upload_s": upload_s,
        "search_s": search_s,
        "mbases_per_s": bases / 1e6 / search_s,
        "runs": runs,
        "sample": want[:6],
        "job": job,
        "ok": not missing and all(r["identical"] and r["hash_ok"] for r in runs),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=0.25,
                    help="synthetic genome size in MB (paper: 512 MB replicated)")
    ap.add_argument("--patterns", type=int, default=24,
                    help="pattern dictionary size (paper: 5000)")
    ap.add_argument("--strategy", default="hybrid",
                    help="registered FT strategy driving the live migration, or 'all'")
    ap.add_argument("--campaign", action="store_true",
                    help="also price the genome_campaign scenario under each strategy")
    ap.add_argument("--device", default="cuda", help="where the search runs: cuda or cpu")
    ap.add_argument("--json", action="store_true", help="last line: one JSON object")
    args = ap.parse_args(argv)
    names = strategies.names() if args.strategy == "all" else [args.strategy]
    res = run(int(args.genome_mb * 1e6), args.patterns, names, args.device)

    print(f"genome: {res['bases'] / 1e6:.2f} MB synthetic C.elegans-like, {res['patterns']} "
          f"patterns of 15-25 bases, 3 search nodes + 1 combiner, on {res['device']}")
    print(f"reference run: {res['n_hits']} hits, search {res['search_s']:.3f} s "
          f"({res['mbases_per_s']:.1f} Mbases/s), upload {res['upload_s']:.3f} s")
    for r in res["runs"]:
        print(f"{r['strategy']:15s} decision rules: {r['rules']}; node0 {r['from']}->{r['to']} "
              f"via {r['mechanism']} ({r['outcome']}), reinstate={r['reinstate_s'] * 1000:.1f} ms, "
              f"hash_ok={r['hash_ok']}, identical to reference: {r['identical']}")
    print(f"planted-pattern recall: {res['truth'] - res['missing']}/{res['truth']}")
    print("seqname  start    end      patternID  strand")
    for h in res["sample"]:
        print(f"{h[0]:8s} {h[1]:<8d} {h[2]:<8d} pattern{h[3]:<8d} {h[4]}")
    ok = res["ok"]
    out = {k: v for k, v in res.items() if k not in ("sample", "job")}
    if args.campaign:
        camp = campaign(names, args.device)
        print(f"campaign '{camp['scenario']}' ({camp['description']}) under workload "
              f"'{camp['workload']}':")
        for r in camp["rows"]:
            if r["survived"]:
                print(f"  {r['strategy']:15s} total={fmt_hms(r['total_s'])} "
                      f"overhead={r['overhead_pct']:5.1f}%  migrations={r['migrations']}")
            else:
                print(f"  {r['strategy']:15s} lost")
        print("paper ordering holds: checkpointing >> multi-agent overhead" if camp["ok"]
              else "campaign check FAILED")
        ok = ok and camp["ok"]
        out["campaign"] = camp
    print("OK" if ok else "FAIL")
    if args.json:
        print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
