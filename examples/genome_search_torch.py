"""The paper's validation job on the PyTorch port: parallel genome pattern
searching with multi-agent fault tolerance (paper §Genome searching).

Three search sub-jobs + one combiner (Z=4, the paper's setup), driven
entirely through the registries — no hand-wired units:

  1. the FT run resolves a registered FaultToleranceStrategy, attaches it
     to the cluster runtime with the REAL sub-job states as payloads, and
     routes a predicted failure through the strategy protocol
     (``on_prediction``). The decision rules pick the mechanism (Rule 1:
     Z<=10 -> core intelligence, as the paper's Table 1 run selects) and
     the combined hit table is verified identical to a failure-free run,
     plus all planted patterns recovered;
  2. the campaign run prices the paper-scale job through the scenario
     engine under the ``genome_search`` workload model (cost surfaces
     calibrated on ``--device``, from ``repro_torch.workloads``),
     reproducing the paper's headline ordering: checkpointing >>
     multi-agent overhead.

    PYTHONPATH=src python examples/genome_search_torch.py [--genome-mb 1]
        [--workload genome_search] [--strategy hybrid] [--device cuda]

The port of ``examples/genome_search.py`` over ``repro_torch``: the same
arguments and checks. The genome and its patterns are numpy's
(``make_genome(seed=7)``, the reference's draws); the search runs on
``--device``, ``cuda`` unless ``--device cpu`` is given (without a card
it raises).
"""
import argparse
import time

from repro_torch.core.failure import FailureEvent
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.rules import decide
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.sim import fmt_hms
from repro_torch.data.genome import GenomeSearchJob, make_genome
from repro_torch.scenarios import registry as scenarios
from repro_torch.scenarios.engine import CampaignEngine
from repro_torch.strategies import registry as strategies
from repro_torch.utils.device import resolve_device
from repro_torch.workloads import registry as workloads
from repro_torch.workloads import resolve as resolve_workload


def main(argv=None):
    """Runs the example; returns the hit tables, the planted truth and the
    campaign's overheads."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=0.25,
                    help="synthetic genome size (paper: 512 MB replicated)")
    ap.add_argument("--patterns", type=int, default=24,
                    help="pattern dictionary size (paper: 5000)")
    ap.add_argument("--workload", default="genome_search",
                    choices=workloads.names(),
                    help="workload model billing the campaign section")
    ap.add_argument("--strategy", default="hybrid",
                    help="registered FT strategy driving the live migration")
    ap.add_argument("--device", default="cuda", help="where the search runs: cuda or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    G = int(args.genome_mb * 1e6)
    genome, patterns, truth = make_genome(G, n_patterns=args.patterns, seed=7)
    job = GenomeSearchJob(genome, patterns, n_search=3, device=str(dev))
    print(f"genome: {G/1e6:.2f} MB synthetic C.elegans-like, "
          f"{len(patterns)} patterns of 15-25 bases, 3 search nodes + 1 combiner, on {dev}")

    # failure-free reference
    t0 = time.perf_counter()
    states = job.sub_job_states()
    for st in states:
        while job.run_sub_job_step(st):
            pass
    want = job.combine(states)
    print(f"reference run: {len(want)} hits in {time.perf_counter()-t0:.2f}s")

    # FT run through the unified strategy protocol: the registered
    # strategy owns the units, the placement policy and the accounting
    spec = scenarios.get("genome_campaign")
    wl = resolve_workload(args.workload, spec, device=dev)
    micro = wl.micro("placentia", n_nodes=4)
    rt = ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia",
                        graph=DependencyGraph.star(3))
    states = job.sub_job_states()
    strat = strategies.get(args.strategy)
    strat.attach(rt, dict(enumerate(states)), micro=micro)
    job.run_sub_job_step(states[0])

    z = rt.graph.degree(0) + 1
    dec = decide(z, genome.nbytes, genome.nbytes)
    print(f"decision rules: Z={z}, S_d={genome.nbytes}B -> {dec.mechanism} ({dec.rule})")

    # predicted failure on node 0 after its first chunk: the strategy
    # migrates the live sub-job state inside the lead window
    ev = FailureEvent(t=900.0, node=0, predictable=True)
    out = strat.on_prediction(ev, strat.pick_target(0, require_free=True))
    rep = out.report
    mech = out.mechanism or rep.get("kind", "checkpoint")
    print(f"migrated node0 {rep.get('from', 0)}->{out.new_host} via {mech}: "
          f"reinstate={rep.get('reinstate_s', out.reinstate_s)*1000:.1f} ms "
          f"(paper: {'0.38' if mech=='core' else '0.47'} s on Placentia), "
          f"hash_ok={rep.get('hash_ok', True)}")

    states[0] = rt.hosts[out.new_host].shard
    for st in states:
        while job.run_sub_job_step(st):
            pass
    got = job.combine(states)
    print(f"FT run: {len(got)} hits; identical to reference: {got == want}")
    found = {(h[1], h[3], h[4]) for h in got}
    missing = [t for t in truth if t not in found]
    print(f"planted-pattern recall: {len(truth)-len(missing)}/{len(truth)}")
    assert got == want and not missing
    print("\nsample output (paper Fig 14 format):")
    print("seqname  start    end      patternID  strand")
    for h in got[:6]:
        print(f"{h[0]:8s} {h[1]:<8d} {h[2]:<8d} pattern{h[3]:<8d} {h[4]}")

    # campaign pricing: the paper-scale job as a registered scenario,
    # billed under the chosen workload's calibrated cost surfaces
    print(f"\ncampaign '{spec.name}' ({spec.description}) under "
          f"workload '{wl.name}':")
    overheads = {}
    for approach in ("central_single", "agent", "core", "hybrid"):
        res = CampaignEngine(spec, approach, workload=wl, device=str(dev)).run()
        ovh = 100.0 * (res.total_s - spec.horizon_s) / spec.horizon_s
        overheads[approach] = ovh
        print(f"  {approach:15s} total={fmt_hms(res.total_s)} "
              f"overhead={ovh:5.1f}%  migrations={res.n_migrations}")
    worst_agent = max(v for k, v in overheads.items() if k != "central_single")
    assert overheads["central_single"] > worst_agent, overheads
    print("paper ordering holds: checkpointing >> multi-agent overhead")
    print("OK")
    return {"hits": got, "reference_hits": want, "truth": truth, "overheads": overheads}


if __name__ == "__main__":
    main()
