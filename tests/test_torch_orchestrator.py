"""The live orchestrator of the port (``repro_torch.orchestrator``) against the
JAX reference (``repro.orchestrator``), on the CPU.

Spool files cross between the packages; the injector axis, the live plan
(under one pinned MicroCosts) and the oracle's choice are the reference's;
the stub daemon (``testing.StubLauncher`` under a ``FakeClock``) gives the
reference's report and trace in every scripted scenario; the worker's step
programs resume each other's checkpoints; an in-process worker under a
fake clock heartbeats and checkpoints at the reference's instants; and real
``python -m repro_torch.orchestrator.worker`` processes run an analytic
campaign (tier 1) and the genome live cert (``slow``) on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core  # before repro.telemetry: a cold import of it is circular
from repro.orchestrator import plan as r_plan
from repro.orchestrator import registry as r_injectors
from repro.orchestrator import testing as r_testing
from repro.orchestrator import worker as r_worker
from repro.orchestrator.daemon import OrchestratorDaemon as RDaemon
from repro.orchestrator.spool import Spool as RSpool
from repro.scenarios import registry as r_scenarios
from repro.scenarios.trajectory import compile_tape as r_compile_tape
from repro.workloads import registry as r_workloads

from repro_torch.core import sim as t_sim
from repro_torch.orchestrator import cli as t_cli
from repro_torch.orchestrator import contract
from repro_torch.orchestrator import plan as t_plan
from repro_torch.orchestrator import registry as t_injectors
from repro_torch.orchestrator import testing as t_testing
from repro_torch.orchestrator import worker as t_worker
from repro_torch.orchestrator.daemon import OrchestratorDaemon as TDaemon
from repro_torch.orchestrator.daemon import SubprocessLauncher
from repro_torch.orchestrator.injector import Injection
from repro_torch.orchestrator.spool import Spool as TSpool
from repro_torch.scenarios import registry as t_scenarios
from repro_torch.scenarios.trajectory import compile_tape as t_compile_tape
from repro_torch.workloads import registry as t_workloads

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
LIVE_SCENARIO = "live_genome_single"
#: fast stub-run scaling, the reference test's: 1 wall second = 900 sim seconds
TIME_SCALE = 900.0
#: the families the injector schedules are held on (a burst, a cascade, and
#: a per-window process with several events)
INJECTOR_FAMILIES = ("live_genome_single", "cascade_spare", "flaky_node")
#: the loss after 8 steps, port against the reference's float32 (relative)
LOSS_RTOL = 1e-6

_MICRO = {}
#: the reference workloads' own ``micro``, kept before ``pinned_micro`` patches it
_REF_MICRO = {name: r_workloads.get_class(name).micro
              for name in ("analytic", "genome_search", "train_llm")}


def micro_pair(workload: str, profile: str, n_nodes: int):
    """One MicroCosts measured by the reference, for both sides (every
    workload's record rests on wall-clock measurements)."""
    key = (workload, profile, n_nodes)
    if key not in _MICRO:
        ref = _REF_MICRO[workload](r_workloads.get(workload), profile, n_nodes=n_nodes)
        _MICRO[key] = (ref, t_sim.MicroCosts(**dataclasses.asdict(ref)))
    return _MICRO[key]


@pytest.fixture
def pinned_micro(monkeypatch):
    """Every workload's ``micro`` in both packages returns the reference's
    record (the port's as a copy), for the test that asks for it."""
    for side, registry in ((0, r_workloads), (1, t_workloads)):
        for name in _REF_MICRO:
            def micro(self, profile="placentia", n_nodes=4, _name=name, _side=side):
                return micro_pair(_name, profile, n_nodes)[_side]

            monkeypatch.setattr(registry.get_class(name), "micro", micro)


@pytest.fixture
def ref_x64(monkeypatch):
    """The reference replay imports ``jax.experimental.enable_x64``, which
    the installed jax has only as ``jax.enable_x64`` (ROADMAP Queue 3, item
    1); restored for the test that asks for it (as ``ref_replay`` in
    tests/test_torch_replay.py does)."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def live_specs(workload="genome_search"):
    specs = []
    for registry in (r_scenarios, t_scenarios):
        spec = registry.get(LIVE_SCENARIO)
        spec.workload = workload
        specs.append(spec)
    return specs


def stub_plans(strategy="central_single", workload="genome_search", **spec_changes):
    """The reference's and the port's LivePlan, priced by each engine but
    laid out for stub workers (the reference test's ``stub_plan``)."""
    r_spec, t_spec = live_specs(workload)
    for k, v in spec_changes.items():
        setattr(r_spec, k, v)
        setattr(t_spec, k, v)
    ref = r_plan.make_live_plan(r_spec, time_scale=TIME_SCALE, seed=0, strategy=strategy,
                                calibrate=False)
    port = t_plan.make_live_plan(t_spec, time_scale=TIME_SCALE, seed=0, strategy=strategy,
                                 calibrate=False, device="cpu")
    return ref, port


def run_stub(pkg, plan, root, *, injector="kill", script=None, launcher_hook=None, **daemon_kw):
    """The reference test's ``run_stub_daemon`` through either package's
    daemon and test doubles. ``script`` and ``launcher_hook`` take the
    launcher, so the same scripted actions reach either package's stubs."""
    testing, Daemon, Spool = pkg
    clock = testing.FakeClock()
    spool = Spool(str(root / "spool"))
    launcher = testing.StubLauncher(spool, clock)
    if launcher_hook is not None:
        launcher_hook(launcher)
    daemon = Daemon(
        plan, spool, launcher, injector=injector, clock=clock,
        async_sleep=testing.scripted_sleeper(
            clock, launcher, script=None if script is None else script(launcher)),
        poll_wall_s=0.05, deadline_wall_s=600.0, **daemon_kw,
    )
    return daemon.run_sync(), daemon, launcher


REF = (r_testing, RDaemon, RSpool)
PORT = (t_testing, TDaemon, TSpool)


def events(trace):
    return [(e.t, e.kind, e.node, e.target, e.meta) for e in trace.events]


def kinds(trace):
    return [e.kind for e in trace.events]


# ---------------------------------------------------------------- spool ---
@pytest.mark.parametrize("writer,reader", [(RSpool, TSpool), (TSpool, RSpool)],
                         ids=["reference-to-port", "port-to-reference"])
def test_spool_is_read_across_packages(tmp_path, writer, reader):
    w, r = writer(str(tmp_path / "sp")), reader(str(tmp_path / "sp"))
    w.write_heartbeat(0, {"t_wall_s": 1.5, "state": "idle", "device": None})
    w.send_command(0, {"op": "assign", "shard": 2}, seq=7)
    w.write_final(0, {"code": 42, "cause": "fault-injected", "shard": 2, "step": 3})
    w.write_checkpoint(3, {"shard": 3, "step": 4, "state": {"w1": [[0.25]]}})
    w.write_result(3, {"shard": 3, "steps_done": 8})
    w.write_status({"state": "running"})
    assert r.read_heartbeat(0) == {"t_wall_s": 1.5, "state": "idle", "device": None}
    assert r.read_command(0) == {"op": "assign", "shard": 2, "seq": 7}
    assert r.read_final(0)["cause"] == "fault-injected"
    assert r.read_checkpoint(3)["state"] == {"w1": [[0.25]]}
    assert r.results(4) == {3: {"shard": 3, "steps_done": 8}}
    assert r.read_status() == {"state": "running"}


@pytest.mark.parametrize("Spool", [RSpool, TSpool], ids=["reference", "port"])
def test_spool_corrupt_file_reads_as_none(tmp_path, Spool):
    TSpool(str(tmp_path / "sp")).write_heartbeat(1, {"t_wall_s": 0.0})
    sp = Spool(str(tmp_path / "sp"))
    with open(os.path.join(sp.worker_dir(1), "hb.json"), "w") as f:
        f.write("{not json")
    assert sp.read_heartbeat(1) is None
    assert TSpool(sp.root).read_heartbeat(1) is None


# ------------------------------------------------------- injector axis ---
def test_injector_registry_matches_reference():
    assert t_injectors.names() == r_injectors.names() == ["none", "kill", "stall", "slow"]
    assert t_injectors._ALIASES == r_injectors._ALIASES
    for name in t_injectors.names():
        assert t_injectors.get(name).name == name
    assert t_injectors.get_class("sigkill") is t_injectors.get_class("kill")
    assert t_injectors.get_class("sigstop") is t_injectors.get_class("stall")
    with pytest.raises(KeyError):
        t_injectors.get("no_such_injector")
    with pytest.raises(ValueError):
        Injection(0, 1.0, "meteor")


@pytest.mark.parametrize("family", INJECTOR_FAMILIES)
def test_injector_schedules_match_reference(family):
    ref_tape = r_compile_tape(r_scenarios.get(family), 0)
    port_tape = t_compile_tape(t_scenarios.get(family), 0)
    assert port_tape.n_slots == ref_tape.n_slots
    for name in t_injectors.names():
        cfg = {"factor": 3.0} if name == "slow" else {}
        want = [dataclasses.astuple(i) for i in r_injectors.get(name, **cfg).schedule(ref_tape)]
        got = [dataclasses.astuple(i) for i in t_injectors.get(name, **cfg).schedule(port_tape)]
        assert got == want, (family, name)
    if family == LIVE_SCENARIO:
        kills = t_injectors.get("kill").schedule(port_tape)
        assert [(i.action, i.t_s) for i in kills] == [("kill", 2250.0)]


# ------------------------------------------------------- planning oracle ---
@pytest.mark.parametrize("workload,strategy", [
    ("genome_search", "central_single"), ("genome_search", "core"),
    ("analytic", "hybrid"), ("train_llm", "agent"),
])
def test_live_plan_matches_reference(pinned_micro, workload, strategy):
    ref, port = stub_plans(strategy, workload)
    assert port.to_dict() == ref.to_dict()
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert port.device == "cpu" and port.n_steps * port.step_sim_s == pytest.approx(3600.0)


@pytest.mark.parametrize("strategy", ["central_single", "hybrid"])
def test_predicted_makespan_matches_reference(pinned_micro, strategy):
    r_spec, t_spec = live_specs()
    want = r_plan.predicted_makespan_s(r_spec, strategy, seed=0)
    assert t_plan.predicted_makespan_s(t_spec, strategy, seed=0, device="cpu") == want


@pytest.mark.parametrize("workload", ["genome_search", "analytic"])
def test_choose_strategy_matches_reference(pinned_micro, ref_x64, workload):
    r_spec, t_spec = live_specs(workload)
    want = r_plan.choose_strategy(r_spec, n_seeds=8, seed=0)
    got = t_plan.choose_strategy(t_spec, n_seeds=8, seed=0, device="cpu")
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.parametrize("family,ratio", [
    ("live_genome_single", 2.0), ("live_genome_single", 0.3),
    ("flaky_node", 3.4), ("cascade_spare", 1.6),
])
def test_scale_failure_rate_matches_reference(family, ratio):
    want = r_plan.scale_failure_rate(r_scenarios.get(family), ratio)
    got = t_plan.scale_failure_rate(t_scenarios.get(family), ratio)
    assert got.to_dict() == want.to_dict()
    assert t_scenarios.get(family).to_dict() == r_scenarios.get(family).to_dict()


def test_drift_monitor_bands_match_reference():
    mons = [m.DriftMonitor(expected_failures=1, horizon_s=3600.0, step_wall_s=0.5)
            for m in (r_plan, t_plan)]
    for m in mons:
        m.observe_failure()
    assert [m.drifted(100.0) for m in mons] == [None, None]  # below min_failures
    for m in mons:
        m.observe_failure()
    got = [m.drifted(100.0) for m in mons]
    assert got[0] == got[1] and got[1]["cause"] == "failure_rate" and got[1]["ratio"] > 1.8

    mons = [m.DriftMonitor(expected_failures=1, horizon_s=3600.0, step_wall_s=0.5)
            for m in (r_plan, t_plan)]
    for lat in [0.55] * 20:
        for m in mons:
            m.observe_step(lat)
    assert [m.drifted(1800.0) for m in mons] == [None, None]  # 1.1x: inside the band
    for lat in [1.5] * 20:
        for m in mons:
            m.observe_step(lat)
    got = [m.drifted(1800.0) for m in mons]
    assert got[0] == got[1] and got[1]["cause"] == "step_time"
    assert mons[1].step_ewma_s == mons[0].step_ewma_s


# ------------------------------------------------- stub daemon campaigns ---
def _drift_script(launcher):
    # two organic kills the spec never declared (its burst says ONE failure
    # per horizon; these double+ the observed rate)
    def kill(host):
        return lambda: launcher.stubs[host].deliver("kill")
    return [(1.0, kill(1)), (1.3, kill(2))]


def _drift_planner(observed_spec, old_plan, drift_info):
    assert drift_info["cause"] == "failure_rate"
    assert observed_spec.processes[0].params["k"] >= 2
    return "hybrid"


def _arm_spawn_failures(launcher):
    def fire():
        launcher.fail_next_spawns = 2
    return [(0.5, fire)]  # armed after the 6 fleet spawns succeed


# the reference test's scenarios: name -> (spec changes for both plans,
# run_stub's keywords given the plan, the reference test's own check on the
# port's report, daemon and launcher)
STUB_SCENARIOS = {
    "kill": ({}, lambda plan: dict(injector="kill"),
             lambda rep, d, lau: rep.n_events == 1 and rep.n_handled == 1
             and kinds(rep.trace).index("failure") < kinds(rep.trace).index("migrate")),
    "stall": ({}, lambda plan: dict(injector="stall",
                                    stall_timeout_wall_s=3.0 * plan.step_wall_s),
              lambda rep, d, lau: rep.n_stalls == 1 and rep.n_handled == 1),
    "slow": ({}, lambda plan: dict(injector="slow", max_replans=0),
             lambda rep, d, lau: rep.n_events == 0 and rep.live_total_s > 3600.0),
    "drift_replan": ({}, lambda plan: dict(injector="none", script=_drift_script,
                                           planner=_drift_planner, max_replans=1),
                     lambda rep, d, lau: rep.n_replans == 1 and rep.final_strategy == "hybrid"
                     and rep.n_handled == 2),
    "respawn_backoff": ({}, lambda plan: dict(injector="kill", script=_arm_spawn_failures,
                                              respawn_backoff_s=0.1),
                        lambda rep, d, lau: rep.n_reprovisioned == 1
                        and lau.n_spawn_attempts == 9),
    "blacklist_ttl": ({"max_strikes": 1}, lambda plan: dict(injector="kill",
                                                            blacklist_ttl_s=600.0),
                      lambda rep, d, lau: rep.n_blacklisted == 1 and d.rt.blacklist == set()),
    "status": ({}, lambda plan: dict(injector="kill"),
               lambda rep, d, lau: d.spool.read_status()["state"] == "done"
               and d.spool.read_status()["n_events"] == 1),
}


@pytest.mark.parametrize("scenario", list(STUB_SCENARIOS))
def test_stub_daemon_matches_reference(pinned_micro, tmp_path, scenario):
    changes, kw, check = STUB_SCENARIOS[scenario]
    ref_plan, port_plan = stub_plans(**changes)
    ref = run_stub(REF, ref_plan, tmp_path / "ref", **kw(ref_plan))
    port = run_stub(PORT, port_plan, tmp_path / "port", **kw(port_plan))
    assert port[0].survived and sorted(port[0].results) == [0, 1, 2, 3]
    assert check(*port), port[0].to_dict()
    assert port[0].to_dict() == ref[0].to_dict()
    assert events(port[0].trace) == events(ref[0].trace)
    assert port[0].trace.source == "live"
    assert port[1].spool.read_status() == ref[1].spool.read_status()
    # the live against predicted makespan of each package's stub run (pytest
    # -s shows it): for the stall scenario the engine's bill has no stall
    # detection on either side (ROADMAP.md Queue 3, item 14)
    print(f"stub {scenario}: rel_err reference {ref[0].rel_err!r}, port {port[0].rel_err!r}, "
          f"live {port[0].live_total_s!r} s, predicted {port[0].predicted_total_s!r} s")


def test_live_trace_exports_like_a_simulated_one(pinned_micro, tmp_path):
    from repro_torch.obs.export import write_chrome_trace

    _, plan = stub_plans()
    rep, _, _ = run_stub(PORT, plan, tmp_path, injector="kill")
    doc = json.load(open(write_chrome_trace(rep.trace, str(tmp_path / "live_trace.json"))))
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert "failure" in names and "migrate" in names


# ------------------------------------------------------ step programs ---
def _run(prog, n):
    for _ in range(n):
        prog.step()
    return prog


def _programs(workload, shard=1, n_shards=4, n_steps=8):
    ref = r_worker.make_program(workload, 0, n_shards, n_steps, shard)
    port = t_worker.make_program(workload, 0, n_shards, n_steps, shard, device="cpu")
    return ref, port


def test_train_program_starts_from_the_reference_weights():
    ref, port = _programs("train_llm")
    assert port.device == torch.device("cpu")
    for name in ("w1", "w2", "x", "y"):
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), name
    assert port.state_dict() == ref.state_dict()


def test_train_program_loss_after_8_steps_matches_reference():
    ref, port = (_run(p, 8) for p in _programs("train_llm"))
    want, got = ref.result(), port.result()
    assert got["steps_done"] == want["steps_done"] == 8
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert got["loss"] < _programs("train_llm")[1].result()["loss"]  # it trains


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
@pytest.mark.parametrize("workload", ["genome_search", "train_llm", "analytic"])
def test_checkpoint_crosses_packages(workload, direction):
    """A shard checkpointed after 3 steps by one package, through JSON,
    finishes in the other with the reference's own result."""
    n_steps = 8
    ref_whole = _run(_programs(workload, n_steps=n_steps)[0], n_steps).result()
    first, second = _programs(workload, n_steps=n_steps)
    if direction == "port-to-reference":
        first, second = second, first
    state = json.loads(json.dumps(_run(first, 3).state_dict()))
    second.load_state(state)
    got = _run(second, n_steps - 3).result()
    if workload == "genome_search":
        assert got["hits"] and {tuple(h) for h in got["hits"]} == {
            tuple(h) for h in ref_whole["hits"]}
    elif workload == "train_llm":
        assert abs(got["loss"] - ref_whole["loss"]) <= LOSS_RTOL * abs(ref_whole["loss"])
    else:
        assert got == ref_whole


def test_genome_program_hits_match_the_job():
    """The port's shard program finds the plain search's hits of its chunks."""
    from repro_torch.data.genome import search_chunk_plain

    prog = _run(_programs("genome_search", shard=2)[1], 8)
    job = prog.job
    want = set()
    for cursor in range(8):
        start, end = job.chunk_bounds(2, cursor)
        nxt = job.chunk_bounds(2, cursor + 1)
        g = torch.from_numpy(job.genome[start:end].copy())
        want |= {h for h in search_chunk_plain(g, job.patterns, start)
                 if nxt is None or h[1] < nxt[0]}
    assert {tuple(h) for h in prog.result()["hits"]} == want


def test_make_program_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for workload in ("genome_search", "train_llm"):
        with pytest.raises(RuntimeError, match="device cpu"):
            t_worker.make_program(workload, 0, 4, 8, 0)
    assert t_worker.make_program("analytic", 0, 4, 8, 0).device is None
    with pytest.raises(KeyError):
        t_worker.make_program("serve_decode", 0, 4, 8, 0, device="cpu")


# ------------------------------------------------------------- the worker ---
def _worker_log(pkg_worker, Spool, root, workload, **kw):
    """Run one in-process Worker under a fake clock: assigned shard 2 of 5
    paced steps, slowed 2x at t=1.0 and stopped at t=4.0. Returns its exit
    code and every heartbeat / checkpoint / result it wrote, in order."""
    clock = r_testing.FakeClock()
    spool = Spool(str(root))
    log = []
    for op in ("write_heartbeat", "write_checkpoint", "write_result", "write_final"):
        real = getattr(spool, op)

        def record(key, payload, _op=op, _real=real):
            log.append((_op, key, payload))
            _real(key, payload)
        setattr(spool, op, record)
    spool.send_command(0, {"op": "assign", "shard": 2, "n_shards": 4, "n_steps": 5,
                           "step_wall_s": 0.5, "ckpt_every_steps": 2}, seq=1)
    script = [(1.0, {"op": "slow", "factor": 2.0}, 2), (4.0, {"op": "stop"}, 3)]

    def sleep(dt_s):
        clock.advance(dt_s)
        while script and script[0][0] <= clock():
            _, cmd, seq = script.pop(0)
            spool.send_command(0, cmd, seq=seq)

    w = pkg_worker.Worker(spool, 0, workload, 0, clock=clock, sleep=sleep,
                          abort_after_s=30.0, **kw)
    return w.run(), log


@pytest.mark.parametrize("workload", ["analytic", "train_llm"])
def test_worker_heartbeats_and_checkpoints_at_reference_steps(tmp_path, workload):
    ref_code, ref_log = _worker_log(r_worker, RSpool, tmp_path / "ref", workload)
    code, log = _worker_log(t_worker, TSpool, tmp_path / "port", workload, device="cpu")
    assert code == ref_code == contract.EXIT_PREEMPTED
    assert [(op, k) for op, k, _ in log] == [(op, k) for op, k, _ in ref_log]
    hb_keys = ("t_wall_s", "state", "shard", "step", "n_steps", "step_latency_s",
               "compute_s", "slow_factor", "warmed")
    for (op, _, got), (_, _, want) in zip(log, ref_log):
        if op == "write_heartbeat":
            assert {k: got[k] for k in hb_keys} == {k: want[k] for k in hb_keys}
            assert got["device"] == (None if workload == "analytic" or got["shard"] is None
                                     else "cpu")
        elif op == "write_checkpoint":
            assert (got["shard"], got["step"]) == (want["shard"], want["step"])
        elif op == "write_final":
            assert got == want
    steps = [p["step"] for op, _, p in log if op == "write_checkpoint"]
    assert steps == [2, 4, 5, 5]  # every 2 steps, the last step, and the stop


_NO_TORCH_WORKER = """
import runpy, sys
from repro_torch.orchestrator.spool import Spool
root = sys.argv[1]
Spool(root).send_command(0, {"op": "assign", "shard": 0, "n_shards": 1, "n_steps": 3,
                             "step_wall_s": 0.0}, seq=1)
sys.argv = ["worker", "--spool", root, "--worker-id", "0", "--workload", "analytic",
            "--abort-after-s", "1.0"]
try:
    runpy.run_module("repro_torch.orchestrator.worker", run_name="__main__")
except SystemExit as e:
    code = e.code
print(code, sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "repro")))
"""


def test_analytic_worker_imports_neither_torch_nor_jax(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_WORKER, str(tmp_path / "sp")], cwd=REPO,
        capture_output=True, text=True, env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
        timeout=120)
    assert res.returncode == 0, res.stderr
    code, mods = res.stdout.strip().split(" ", 1)
    assert int(code) == contract.EXIT_STALLED and mods == "[]", res.stdout
    assert TSpool(str(tmp_path / "sp")).read_result(0)["steps_done"] == 3


def test_worker_on_cuda_without_a_card_fails_while_booting(tmp_path, monkeypatch):
    """A torch worker beats "booting" before its torch import and device, and
    fails there, before any command, where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = TSpool(str(tmp_path / "sp"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_worker.main(["--spool", sp.root, "--worker-id", "0", "--workload", "genome_search"])
    hb = sp.read_heartbeat(0)
    assert hb["state"] == "booting" and hb["device"] is None and not hb["warmed"]
    assert sp.read_final(0) is None


def test_launcher_passes_the_device_to_every_worker(tmp_path):
    sp = TSpool(str(tmp_path / "sp"))
    for device in ("cuda", "cpu"):
        argv, env = SubprocessLauncher(sp, "genome_search", 3, device=device).command(5)
        assert argv[1:3] == ["-m", "repro_torch.orchestrator.worker"]
        assert argv[argv.index("--device") + 1] == device
        assert argv[argv.index("--worker-id") + 1] == "5"
        assert env["PYTHONPATH"].split(os.pathsep)[0] == str(REPO / "src")


# --------------------------------------------------- real subprocesses ---
def test_subprocess_analytic_campaign_end_to_end(tmp_path):
    """4 real port worker processes, the injector kills one, the daemon
    completes the campaign (the reference test's assertions)."""
    _, spec = live_specs(workload="analytic")
    plan = t_plan.make_live_plan(spec, time_scale=1800.0, seed=0, strategy="central_single",
                                 device="cpu")
    spool = TSpool(str(tmp_path / "spool"))
    launcher = SubprocessLauncher(spool, "analytic", plan.seed, abort_after_s=120.0,
                                  device="cpu")
    daemon = TDaemon(plan, spool, launcher, injector="kill", deadline_wall_s=90.0)
    rep = daemon.run_sync()
    assert rep.survived, rep.to_dict()
    assert rep.n_handled == 1
    assert sorted(rep.results) == [0, 1, 2, 3]
    assert all(r["steps_done"] == plan.n_steps for r in rep.results.values())
    ks = kinds(rep.trace)
    assert ks.index("failure") < ks.index("verdict") < ks.index("migrate")
    assert rep.live_total_s is not None and rep.rel_err < 0.35
    assert sorted(daemon.ready_s["first heartbeat"]) == list(range(6))
    assert all(w.proc.poll() is not None for w in daemon.handles.values())


@pytest.mark.slow
def test_subprocess_genome_live_cert(tmp_path):
    """The end-to-end live cert on the CPU: port genome-search shards
    supervised with the oracle-chosen strategy, live makespan within the
    reference's tolerance of the engine's prediction."""
    _, spec = live_specs(workload="genome_search")
    plan = t_plan.make_live_plan(spec, time_scale=240.0, seed=0, strategy=None,
                                 candidates=("central_single", "core"), n_seeds=24,
                                 device="cpu")
    assert plan.scores
    spool = TSpool(str(tmp_path / "spool"))
    launcher = SubprocessLauncher(spool, "genome_search", plan.seed, abort_after_s=300.0,
                                  device="cpu")
    daemon = TDaemon(plan, spool, launcher, injector="kill", deadline_wall_s=240.0)
    rep = daemon.run_sync()
    assert rep.survived, rep.to_dict()
    assert rep.n_handled == 1 and sorted(rep.results) == [0, 1, 2, 3]
    assert all("hits" in r["payload"] for r in rep.results.values())
    ks = kinds(rep.trace)
    assert ks.index("failure") < ks.index("verdict") < ks.index("migrate")
    assert rep.rel_err < 0.25, (rep.live_total_s, rep.predicted_total_s)
    holders = [hb for hb in (spool.read_heartbeat(w) for w in daemon.handles)
               if hb is not None and hb["shard"] is not None]
    assert len(holders) >= 4 and all(hb["device"] == "cpu" for hb in holders)


# ------------------------------------------------------------------ CLI ---
def test_cli_status_reads_the_spool(tmp_path, capsys):
    sp = TSpool(str(tmp_path / "spool"))
    assert t_cli.main(["status", "--spool", sp.root, "--json"]) == 1  # no daemon yet
    assert json.loads(capsys.readouterr().out) == {"state": "unknown"}
    RSpool(sp.root).write_status({"state": "running", "shards_done": 2})
    assert t_cli.main(["status", "--spool", sp.root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == {"state": "running", "shards_done": 2}


def test_cli_run_without_a_card_and_without_device_cpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spool = tmp_path / "spool"
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_cli.main(["run", "--workload", "analytic", "--strategy", "central_single",
                    "--time-scale", "1800", "--spool", str(spool), "--json"])
    assert not spool.exists()  # nothing planned, launched or written
    with pytest.raises(RuntimeError, match="device cpu"):
        t_plan.make_live_plan(live_specs()[1], time_scale=240.0, strategy="core",
                              calibrate=False)


def test_module_entry_point_runs_the_cli(tmp_path):
    sp = TSpool(str(tmp_path / "spool"))
    sp.write_status({"state": "done"})
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.orchestrator", "status", "--spool", sp.root,
         "--json"], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": ""}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {"state": "done"}


def test_measure_step_wall_s_reports_the_plain_surface_on_the_cpu():
    cal = t_plan.measure_step_wall_s("train_llm", n_shards=4, n_steps=8, device="cpu")
    assert cal["step_wall_s"] > 0 and cal["backend"] == "cpu"
    surf = cal["surface"]
    assert surf["impl"] == "plain" and surf["kernel"] == "flash_attention"
    assert surf["n_shards"] == [4] and surf["launches"] == 0
    cal = t_plan.measure_step_wall_s("analytic", n_shards=4, n_steps=8, device="cpu")
    assert cal["backend"] == "python" and cal["surface"] is None


class _SlowBoot(t_testing.StubWorker):
    """A stub torch worker: silent for its interpreter's start, one
    "booting" beat at ``heard_at_s``, then silent until ``boot_until_s``
    (its torch import and device context)."""

    def start(self):
        pass

    def pump(self):
        now_s = self.clock()
        if now_s >= self.boot_until_s:
            super().pump()
        elif now_s >= self.heard_at_s and self.spool.read_heartbeat(self.wid) is None:
            self._hb("booting")


def _respawn_booting(plan, tmp_path, boot_s, ready_s):
    """The stub kill campaign whose respawned worker boots for ``boot_s``,
    under a ready timeout of ``ready_s``."""
    class Launcher(t_testing.StubLauncher):
        def launch(self, wid):
            if wid < 6:  # the fleet boots at once
                return super().launch(wid)
            s = _SlowBoot(wid, self.spool, self.clock)
            s.heard_at_s = self.clock() + 0.5
            s.boot_until_s = self.clock() + boot_s
            self.stubs[wid] = s
            s.start()
            return s

    clock = t_testing.FakeClock()
    spool = TSpool(str(tmp_path / "spool"))
    launcher = Launcher(spool, clock)
    daemon = TDaemon(plan, spool, launcher, injector="kill", clock=clock,
                     async_sleep=t_testing.scripted_sleeper(clock, launcher),
                     poll_wall_s=0.05, deadline_wall_s=600.0,
                     stall_timeout_wall_s=3.0 * plan.step_wall_s, ready_timeout_wall_s=ready_s)
    return daemon, daemon.run_sync()


def test_respawned_worker_is_not_stalled_while_it_boots(pinned_micro, tmp_path):
    """A repaired host's new worker whose boot outlasts the stall timeout (a
    cold torch import on a busy host) is not reaped as stalled, neither
    before its first beat nor while its last beat says "booting"."""
    _, plan = stub_plans()
    daemon, rep = _respawn_booting(plan, tmp_path, 3.0 * plan.step_wall_s + 0.5, 10.0)
    assert rep.survived and rep.n_reprovisioned == 1 and sorted(rep.results) == [0, 1, 2, 3]
    assert rep.n_stalls == 0 and rep.n_events == 1
    assert 6 in daemon._hb_seen and 6 not in daemon._booting_since  # booted, then heard


def test_worker_booting_past_the_ready_timeout_is_stalled(pinned_micro, tmp_path):
    """The booting exemption ends at the ready timeout: a respawned worker
    that never finishes booting is reaped by the stall rule."""
    _, plan = stub_plans()
    daemon, rep = _respawn_booting(plan, tmp_path, 1e9, 2.0)
    assert rep.survived and rep.n_reprovisioned == 1 and rep.n_stalls == 1
    assert 6 in daemon._dead_wids and 6 in daemon._booting_since
