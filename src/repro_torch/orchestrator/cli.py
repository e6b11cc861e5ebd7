"""``python -m repro_torch.orchestrator`` — run and inspect live campaigns.

The port of ``repro.orchestrator.cli``. ``run`` plans, launches and
supervises on the card unless ``--device cpu`` is given; without a card
it raises rather than run on the CPU.

::

    # supervise the live-cert campaign with the oracle-chosen strategy,
    # genome workers on the card
    python -m repro_torch.orchestrator run --scenario live_genome_single \\
        --time-scale 240 --spool live0 --json

    # 4 analytic workers on the CPU, injector kills one
    python -m repro_torch.orchestrator run --scenario live_genome_single \\
        --device cpu --workload analytic --time-scale 1800 \\
        --strategy central_single --export-trace trace.json --json

    # machine-readable daemon status (reads the spool's daemon.json)
    python -m repro_torch.orchestrator status --spool live0 --json

``run`` exits 0 when the campaign survived, 1 when it was lost.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile


def _cmd_run(a) -> int:
    from repro_torch.orchestrator.daemon import OrchestratorDaemon, SubprocessLauncher
    from repro_torch.orchestrator.plan import make_live_plan
    from repro_torch.orchestrator.spool import Spool
    from repro_torch.scenarios import registry as scenario_registry

    spec = scenario_registry.get(a.scenario)
    if a.workload is not None:
        spec.workload = a.workload
    plan = make_live_plan(
        spec,
        time_scale=a.time_scale,
        seed=a.seed,
        strategy=None if a.strategy == "auto" else a.strategy,
        detector=a.detector,
        workload=spec.workload,
        n_seeds=a.plan_seeds,
        device=a.device,  # no card: raises here, never runs on the CPU
    )
    spool_dir = a.spool or tempfile.mkdtemp(prefix="repro_orchestrator_")
    spool = Spool(spool_dir)
    launcher = SubprocessLauncher(spool, spec.workload, plan.seed, device=plan.device)
    daemon = OrchestratorDaemon(
        plan,
        spool,
        launcher,
        injector=a.injector,
        max_replans=a.max_replans,
        deadline_wall_s=a.deadline_wall_s,
    )
    rep = daemon.run_sync()
    if a.export_trace and rep.trace is not None:
        from repro_torch.obs.export import write_chrome_trace

        write_chrome_trace(rep.trace, a.export_trace)
    if a.json:
        out = rep.to_dict()
        out["plan"] = plan.to_dict()
        out["device"] = plan.device
        out["spool"] = spool_dir
        print(json.dumps(out))
    else:
        print(
            f"[orchestrator] {spec.name} on {plan.device}: strategy={rep.final_strategy} "
            f"survived={rep.survived} live={rep.live_total_s and round(rep.live_total_s, 1)}s "
            f"predicted={round(rep.predicted_total_s, 1)}s "
            f"migrations={rep.n_migrations} replans={rep.n_replans} spool={spool_dir}"
        )
    return 0 if rep.survived else 1


def _cmd_status(a) -> int:
    from repro_torch.orchestrator.spool import Spool

    status = Spool(a.spool).read_status()
    if status is None:
        print(json.dumps({"state": "unknown"}) if a.json else "no daemon status found")
        return 1
    print(json.dumps(status) if a.json else str(status))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.orchestrator", description="live fault-tolerance orchestrator"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="plan, launch and supervise one live campaign")
    r.add_argument("--scenario", default="live_genome_single")
    r.add_argument("--workload", default=None, help="override the spec's workload")
    r.add_argument("--strategy", default="auto", help='"auto" consults the oracle')
    r.add_argument("--detector", default="ewma_straggler")
    r.add_argument("--device", default="cuda",
                   help="where the oracle and the workers run (cuda or cpu)")
    r.add_argument("--injector", default="kill")
    r.add_argument("--time-scale", type=float, default=120.0,
                   help="simulated seconds per wall second")
    r.add_argument("--seed", type=int, default=None)
    r.add_argument("--spool", default=None, help="spool dir (default: fresh tempdir)")
    r.add_argument("--plan-seeds", type=int, default=200,
                   help="Monte-Carlo seeds per candidate strategy")
    r.add_argument("--max-replans", type=int, default=1)
    r.add_argument("--deadline-wall-s", type=float, default=None,
                   help="abort (campaign lost) after this much wall time")
    r.add_argument("--export-trace", default=None,
                   help="write the live CampaignTrace as a Perfetto/Chrome trace")
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=_cmd_run)

    s = sub.add_parser("status", help="read a running daemon's status file")
    s.add_argument("--spool", required=True)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=_cmd_status)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
