"""The paper's fault-tolerance path in the port against the JAX reference:
tree helpers, the FT machinery, the strategies, the simulator, Tables 1-2
byte for byte under one pinned MicroCosts, and the failure predictor."""
import dataclasses
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import repro.core  # before anything that imports repro.telemetry (a circular import)
from repro.core import checkpoint as r_ckpt
from repro.core import cluster as r_cluster
from repro.core import failure as r_failure
from repro.core import heartbeat as r_heartbeat
from repro.core import sim as r_sim
from repro.core.predictor import FailurePredictor as RPredictor
from repro.scenarios import registry as r_scenarios
from repro.strategies import base as r_base
from repro.strategies import registry as r_registry
from repro.utils import tree as r_tree

from repro_torch.convert import predictor_from_jax
from repro_torch.core import checkpoint as t_ckpt
from repro_torch.core import cluster as t_cluster
from repro_torch.core import failure as t_failure
from repro_torch.core import heartbeat as t_heartbeat
from repro_torch.core import sim as t_sim
from repro_torch.core.predictor import FailurePredictor as TPredictor
from repro_torch.launch import genome as t_genome_launch
from repro_torch.launch import tables as t_tables
from repro_torch.strategies import base as t_base
from repro_torch.strategies import registry as t_registry
from repro_torch.utils import tree as t_tree

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))  # the reference benches import as `benchmarks.*`

def _side(pkg):
    """The FT machinery of one package, by the names tests/test_ft.py uses."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        Agent=m("core.agent").Agent,
        HybridUnit=m("core.hybrid").HybridUnit,
        DependencyGraph=m("core.migration").DependencyGraph,
        ClusterRuntime=m("core.runtime").ClusterRuntime,
        VirtualCore=m("core.virtual_core").VirtualCore,
        rules=m("core.rules"),
        tree_hash=m("utils.tree").tree_hash,
    )


def _payload(n=1024):
    return {"partial": np.arange(n, dtype=np.float32), "cursor": 7}


@pytest.fixture(scope="module")
def micro():
    """One pinned MicroCosts, measured by the reference, for both sides."""
    ref = r_sim.measure_micro("placentia", n_nodes=4, z=4, s_d_bytes=(2 ** 19) * 1024)
    return ref, t_sim.MicroCosts(**dataclasses.asdict(ref))


# ------------------------------------------------------------------ tree ---
def _tree():
    return {
        "b": [np.arange(6, dtype=np.int32).reshape(2, 3), (np.float32(2.5), 3, "chrI")],
        "a": {"z": torch.arange(4, dtype=torch.float32), "y": None,
              "x": torch.ones((2, 2), dtype=torch.bfloat16)},
        "c": (np.zeros((0,), np.float64),),
    }


def test_tree_leaves_and_bytes_match_reference():
    tree = _tree()
    as_np = t_tree.tree_map(t_tree.as_numpy, tree)
    tensors_as_np = t_tree.tree_map(
        lambda x: t_tree.as_numpy(x) if isinstance(x, torch.Tensor) else x, tree)
    leaves, treedef = t_tree.flatten(tree)
    ref_leaves = jax.tree.leaves(as_np)
    assert len(leaves) == len(ref_leaves) == 7
    for got, want in zip(leaves, ref_leaves):
        assert np.array_equal(t_tree.as_numpy(got), np.asarray(want))
    # the bf16 leaf is 2 bytes an element in the port, 4 after widening
    assert t_tree.tree_bytes(tree) == r_tree.tree_bytes(tensors_as_np) - 4 * 2
    assert t_tree.tree_count(tree) == r_tree.tree_count(tensors_as_np)
    assert t_tree.tree_equal(t_tree.unflatten(treedef, leaves), tree)


def test_tree_hash_and_equal_detect_changes():
    a, b = _tree(), _tree()
    assert t_tree.tree_hash(a) == t_tree.tree_hash(b) and t_tree.tree_equal(a, b)
    b["a"]["z"][1] = 9.0
    assert t_tree.tree_hash(a) != t_tree.tree_hash(b) and not t_tree.tree_equal(a, b)
    c = _tree()
    c["a"]["x"] = c["a"]["x"].float()  # same values, another dtype
    assert t_tree.tree_hash(a) != t_tree.tree_hash(c)
    d = _tree()
    d["b"] = tuple(d["b"])  # same leaves, another structure
    assert t_tree.tree_hash(a) != t_tree.tree_hash(d) and not t_tree.tree_equal(a, d)


# --------------------------------------------------- FT machinery (test_ft) ---
def _agent_migration(s):
    rt = s.ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia")
    p = _payload()
    h0 = s.tree_hash(p)
    rt.occupy(0, p, "agent:0")
    z_before = rt.graph.degree(0)
    ag = s.Agent(0, 0, p)
    rep = ag.migrate(rt)
    assert rep["hash_ok"] and s.tree_hash(ag.payload) == h0
    assert rt.hosts[0].shard is None and rt.hosts[ag.host].shard is not None
    assert rt.graph.degree(ag.host) == z_before and rt.graph.degree(0) == 0
    return (rep["from"], rep["to"], rep["bytes"], rep["edges"], rep["reinstate_modelled_s"],
            rep["staging_modelled_s"], sorted(rt.graph.in_edges.items()))


def _core_faster_than_agent(s):
    reps = {}
    for mech in ("agent", "core"):
        rt = s.ClusterRuntime(n_hosts=6, n_spares=1, profile="placentia")
        p = _payload()
        rt.occupy(0, p, mech)
        reps[mech] = (s.Agent(0, 0, p).migrate(rt) if mech == "agent"
                      else s.VirtualCore(0, 0).migrate_job(rt))
    assert reps["core"]["reinstate_s"] < reps["agent"]["reinstate_s"]
    return {m: (r["to"], r["edges"], r["reinstate_modelled_s"]) for m, r in reps.items()}


def _rules_thresholds(s):
    r = s.rules
    small, big = 1024, r.SD_THRESHOLD_BYTES * 2
    out = [r.decide(4, big, big), r.decide(r.Z_THRESHOLD, big, big), r.decide(50, small, big),
           r.decide(50, big, small), r.decide(50, big, big),
           r.negotiate("agent", "agent", 50, big, big), r.negotiate("agent", "core", 4, small, small)]
    assert [d.mechanism for d in out] == ["core", "core", "agent", "agent", "core", "agent", "core"]
    return [dataclasses.astuple(d) for d in out]


def _hybrid_dispatch(s):
    rt = s.ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia")
    p = _payload()
    rt.occupy(0, p, "hybrid:0")
    rep = s.HybridUnit(s.Agent(0, 0, p), s.VirtualCore(0, 0)).handle_prediction(rt)
    assert rep["mechanism"] == "core" and rep["hash_ok"]
    return rep["mechanism"], rep["decision"], rep["to"], rep["edges"]


def _spare_preference(s):
    rt = s.ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia")
    first = rt.pick_target(0)
    assert first == 4
    rt.occupy(4, _payload(), "x")
    t = rt.pick_target(0)
    assert t != 0 and rt.healthy(t)
    return first, t


def _failed_neighbour(s):
    rt = s.ClusterRuntime(n_hosts=4, n_spares=0, profile="placentia")
    rt.heartbeats.mark_failed(1)
    t = rt.pick_target(0)
    assert t not in (0, 1)
    return t


def _reduction_tree(s):
    g = s.DependencyGraph.reduction_tree(8)
    assert all(len(g.out_edges[i]) == 1 for i in range(8))
    assert len(g.in_edges[max(g.in_edges)]) == 2 and len(g.in_edges[8]) == 2
    return sorted(g.in_edges.items()), sorted(g.out_edges.items())


def _star(s):
    g = s.DependencyGraph.star(3)
    assert g.degree(3) == 3 and all(g.degree(i) == 1 for i in range(3))
    return sorted(g.in_edges.items()), sorted(g.out_edges.items())


@pytest.mark.parametrize("case", [_agent_migration, _core_faster_than_agent, _rules_thresholds,
                                  _hybrid_dispatch, _spare_preference, _failed_neighbour,
                                  _reduction_tree, _star], ids=lambda f: f.__name__.strip("_"))
def test_ft_case_matches_reference(case):
    assert case(_side("repro_torch")) == case(_side("repro"))


def test_decide_and_negotiate_match_reference_on_a_grid():
    rr, tr = _side("repro").rules, _side("repro_torch").rules
    sizes = (0, 1024, rr.SD_THRESHOLD_BYTES, rr.SD_THRESHOLD_BYTES + 1, 2 ** 40)
    prefs = ("agent", "core")
    for z in (0, 1, 4, 10, 11, 50):
        for s_d in sizes:
            for s_p in sizes:
                assert dataclasses.astuple(tr.decide(z, s_d, s_p)) == \
                    dataclasses.astuple(rr.decide(z, s_d, s_p))
                for a in prefs:
                    for c in prefs:
                        assert dataclasses.astuple(tr.negotiate(a, c, z, s_d, s_p)) == \
                            dataclasses.astuple(rr.negotiate(a, c, z, s_d, s_p))


@pytest.mark.parametrize("kind", r_ckpt.CHECKPOINT_KINDS)
def test_modelled_checkpoint_costs_bitwise(kind):
    assert t_ckpt.CHECKPOINT_KINDS == r_ckpt.CHECKPOINT_KINDS
    for name in r_cluster.PROFILES:
        for asynchronous in (False, True):
            for n_nodes, total in ((4, 3 * 2 ** 29), (1, 1), (16, 12345)):
                rc = r_ckpt.CheckpointPolicyCfg(kind=kind, n_servers=3, asynchronous=asynchronous)
                tc = t_ckpt.CheckpointPolicyCfg(kind=kind, n_servers=3, asynchronous=asynchronous)
                rp, tp = r_cluster.get_profile(name), t_cluster.get_profile(name)
                assert t_ckpt.modelled_checkpoint_overhead_s(tc, tp, total, n_nodes) == \
                    r_ckpt.modelled_checkpoint_overhead_s(rc, rp, total, n_nodes)
                assert t_ckpt.modelled_restore_s(tc, tp, total, n_nodes) == \
                    r_ckpt.modelled_restore_s(rc, rp, total, n_nodes)


def test_checkpoint_store_round_trip_tensors_and_arrays(tmp_path):
    state = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "h": torch.linspace(-2, 2, 7).to(torch.bfloat16),
        "ids": torch.tensor([3, 1, 2], dtype=torch.int64),
        "partial": np.arange(5, dtype=np.float32),
        "cursor": 7,
    }
    store = t_ckpt.CheckpointStore(str(tmp_path / "ckpt"))
    rep = store.save(state, 1)
    assert rep["written"] == 5 and rep["bytes"] == 48 + 14 + 24 + 20 + 8
    back, info = store.restore(1, state)
    assert info["hash_ok"] and t_tree.tree_equal(back, state)
    for k in ("w", "h", "ids"):
        assert isinstance(back[k], torch.Tensor) and back[k].dtype == state[k].dtype
        assert back[k].device == state[k].device and torch.equal(back[k], state[k])
    assert isinstance(back["partial"], np.ndarray) and back["cursor"] == 7
    # incremental: only the changed leaf is written again
    state["w"] = state["w"] + 1
    rep2 = store.save(state, 2, incremental_against=1)
    assert (rep2["written"], rep2["reused"]) == (1, 4) and store.latest_step() == 2
    # the asynchronous writer snapshots: a later in-place write does not leak in
    ac = t_ckpt.AsyncCheckpointer(store)
    ac.save_async(state, 3)
    state["w"].add_(100)
    state["partial"] += 100
    ac.wait()
    back3, _ = store.restore(3, state)
    assert torch.equal(back3["w"], state["w"] - 100)
    assert np.array_equal(back3["partial"], state["partial"] - 100)


def test_numpy_checkpoint_matches_reference_store(tmp_path):
    state = {"partial": np.arange(9, dtype=np.float32).reshape(3, 3),
             "hits": [np.arange(4, dtype=np.int64)], "cursor": 3}
    rs, ts = r_ckpt.CheckpointStore(str(tmp_path / "r")), t_ckpt.CheckpointStore(str(tmp_path / "t"))
    rrep, trep = rs.save(state, 5), ts.save(state, 5)
    for k in ("bytes", "written_bytes", "written", "reused"):
        assert trep[k] == rrep[k]
    rb, _ = rs.restore(5, state)
    tb, _ = ts.restore(5, state)
    assert jax.tree.structure(rb) == jax.tree.structure(tb)
    for a, b in zip(jax.tree.leaves(rb), jax.tree.leaves(tb)):
        assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("kind", ["periodic", "random", "none"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_failure_model_tapes_equal(kind, seed):
    kw = dict(kind=kind, n_nodes=4, horizon_s=5 * 3600.0, per_window=5 if kind == "random" else 1,
              seed=seed)
    want = r_failure.FailureModel(**kw).events()
    got = t_failure.FailureModel(**kw).events()
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert t_failure.mean_random_failure_time(3600.0, seed=seed) == \
        r_failure.mean_random_failure_time(3600.0, seed=seed)


def test_heartbeat_telemetry_equal():
    racks = {0: 0, 1: 0, 2: 1, 3: 1}
    r = r_heartbeat.HeartbeatService(4, seed=5, racks=racks, clock=lambda: 10.0)
    t = t_heartbeat.HeartbeatService(4, seed=5, racks=racks, clock=lambda: 10.0)
    for svc in (r, t):
        svc.mark_degrading(1)
        svc.mark_failed(3)
        svc.beat(0)
        svc.beat(2, at_s=4.0)
    for _ in range(5):
        a, b = r.tick(), t.tick()
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(r.latency_ewma, t.latency_ewma)
    assert t.stalled(3.0) == r.stalled(3.0) == [2]
    assert t.add_node(rack=1) == r.add_node(rack=1)


# ------------------------------------------------------------- strategies ---
def test_strategy_order_and_aliases_match_reference():
    assert t_registry.names() == r_registry.names() == [
        "cold_restart", "central_single", "central_multi", "decentral", "agent", "core", "hybrid"]
    assert t_registry.get_class("checkpoint").name == "central_single"


@pytest.mark.parametrize("name", r_registry.names())
def test_strategy_costs_match_reference(name, micro):
    r_micro, t_micro = micro
    rs, ts = r_registry.get(name), t_registry.get(name)
    assert (ts.proactive, ts.tabulated, ts.wants_checkpoints) == \
        (rs.proactive, rs.tabulated, rs.wants_checkpoints)
    for p_h in (1.0, 2.0, 3.0, 4.0):
        for z, s_d in ((4, 2 ** 29), (50, 1024), (50, 2 ** 45)):
            rc = r_base.CostContext(micro=r_micro, period_h=p_h, z=z, s_d_bytes=s_d)
            tc = t_base.CostContext(micro=t_micro, period_h=p_h, z=z, s_d_bytes=s_d)
            assert dataclasses.astuple(ts.costs(tc)) == dataclasses.astuple(rs.costs(rc))
            assert dataclasses.astuple(ts.cost_table(tc)) == dataclasses.astuple(rs.cost_table(rc))
    if not ts.tabulated:
        assert [dataclasses.astuple(r) for r in ts.table_rows(5.0)] == \
            [dataclasses.astuple(r) for r in rs.table_rows(5.0)]


# ------------------------------------------------------------- simulator ---
def test_measure_micro_modelled_tier_matches_reference(micro):
    r_micro, _ = micro
    got = t_sim.measure_micro("placentia", n_nodes=4, z=4, s_d_bytes=(2 ** 19) * 1024)
    assert t_sim.measure_micro("placentia", n_nodes=4) is got  # memoised on the full tuple
    for f in ("predict_s", "agent_overhead_s", "core_overhead_s", "ckpt_overhead_s",
              "ckpt_reinstate_s"):
        assert getattr(got, f) == getattr(r_micro, f), f
    # the reinstate tier adds a wall-clock measurement (measured_*_s) to its
    # modelled part: the modelled part agrees up to the rounding of the sums
    for mech in ("agent", "core"):
        modelled = getattr(got, f"{mech}_reinstate_s") - getattr(got, f"measured_{mech}_s")
        want = getattr(r_micro, f"{mech}_reinstate_s") - getattr(r_micro, f"measured_{mech}_s")
        assert modelled == pytest.approx(want, rel=0, abs=1e-12), mech


@pytest.mark.parametrize("job_h,periods,offset", [(1.0, [1.0], 15.0), (5.0, [1.0, 2.0, 4.0], None),
                                                  (3.0, [1.5, 3.0], 20.0)])
def test_strategy_rows_bitwise_under_pinned_micro(job_h, periods, offset, micro):
    r_micro, t_micro = micro
    want = r_sim.strategy_rows(job_h, periods, micro=r_micro, periodic_offset_min=offset)
    got = t_sim.strategy_rows(job_h, periods, micro=t_micro, periodic_offset_min=offset)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert [t_sim.fmt_hms(r.exec_5random_s) for r in got] == \
        [r_sim.fmt_hms(r.exec_5random_s) for r in want]


@pytest.mark.parametrize("scenario", ["table1_periodic", "table1_random", "table2_random"])
def test_scenario_totals_closed_form_bitwise(scenario, micro):
    r_micro, t_micro = micro
    spec = r_scenarios.get(scenario)
    want = r_sim.scenario_totals(spec, micro=r_micro)
    assert t_sim.scenario_totals(spec, micro=t_micro) == want
    # a scenario without a closed form runs through the campaign engine,
    # given by name as well
    got = t_sim.scenario_totals("rack_outage", micro=t_micro, device="cpu")
    assert got == r_sim.scenario_totals("rack_outage", micro=r_micro)
    assert {v["source"] for v in got.values()} == {"engine"}


# ------------------------------------------------------------- Tables 1-2 ---
@pytest.mark.parametrize("table", ["table1", "table2"])
def test_table_csv_byte_identical_to_reference_bench(table, micro, tmp_path, monkeypatch):
    r_micro, t_micro = micro
    common = importlib.import_module("benchmarks.common")
    bench = importlib.import_module(f"benchmarks.bench_{table}")
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(bench, "measure_micro", lambda *a, **k: r_micro)
    rpath, rrows, rchecks = bench.run()
    tpath, trows, tchecks = getattr(t_tables, table)(str(tmp_path / "port"), t_micro)
    assert Path(tpath).read_bytes() == Path(rpath).read_bytes()
    assert trows == rrows and tchecks == rchecks and all(tchecks.values())
    assert [r["strategy"] for r in trows] == [r["strategy"] for r in rrows]


def test_tables_launcher_on_cpu(micro, tmp_path, capsys):
    res = t_tables.run(str(tmp_path), device="cpu", micro=micro[1])
    assert res["device"] == "cpu" and all(res["checks"].values())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prediction.csv", "table1.csv",
                                                          "table2.csv"]


@pytest.mark.parametrize("launcher", [t_tables, t_genome_launch], ids=["tables", "genome"])
def test_launchers_without_cuda_and_without_device_cpu_raise(launcher, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--out", str(tmp_path)] if launcher is t_tables else [])


# -------------------------------------------------------------- predictor ---
@pytest.fixture(scope="module")
def predictors():
    return RPredictor.train(seed=0), TPredictor.train(seed=0, device="cpu")


def test_predictor_weights_and_threshold_match_reference(predictors):
    ref, port = predictors
    np.testing.assert_allclose(port.params["w"].numpy(), np.asarray(ref.params["w"]),
                               rtol=0, atol=1e-5)
    assert abs(float(port.params["b"]) - float(ref.params["b"])) <= 1e-5
    assert port.threshold == ref.threshold
    assert np.array_equal(port.mu, ref.mu) and np.array_equal(port.sd, ref.sd)


def test_predictor_evaluate_counts_match_reference(predictors):
    ref, port = predictors
    assert port.evaluate(seed=99) == ref.evaluate(seed=99)


def test_predictor_from_jax_scores_within_1e6(predictors):
    ref, _ = predictors
    port = predictor_from_jax({k: np.asarray(v) for k, v in ref.params.items()},
                              ref.mu, ref.sd, ref.threshold)
    x = np.stack([t_heartbeat.TelemetryModel(4).sample(s) for s in ["healthy", "degrading"] * 50])
    np.testing.assert_allclose(port.score_many(x), ref.score_many(x), rtol=0, atol=1e-6)
    assert port.score(x[1]) == pytest.approx(ref.score(x[1]), abs=1e-6)
    assert [port.predict(f) for f in x] == [ref.predict(f) for f in x]


def test_runtime_neighbour_predictions_use_the_predictor(predictors):
    ref, port = predictors
    sides = {}
    for pkg, pred in (("repro", ref), ("repro_torch", port)):
        rt = _side(pkg).ClusterRuntime(n_hosts=4, n_spares=1, profile="placentia", seed=2)
        rt.predictor = pred
        rt.heartbeats.mark_degrading(1)
        rt.heartbeats.mark_failed(3)
        for _ in range(3):
            rt.heartbeats.tick()
        sides[pkg] = [rt.neighbour_predictions(h) for h in range(4)]
    assert sides["repro_torch"] == sides["repro"]
    assert sides["repro_torch"][0] == {4: False, 1: True}  # ring of 5: the spare, the degrader
    assert sides["repro_torch"][2] == {1: True, 3: True}  # the degrader, the failed host
