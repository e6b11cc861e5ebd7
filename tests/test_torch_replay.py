"""The port's batched replay fold and Monte-Carlo against the JAX reference:
the fold bit for bit against the reference's ``replay_batch``, trial for
trial against ``CampaignEngine`` under the three detectors, the execution
knobs (``tile_slots``, ``n_devices``, the pairwise/argsort ranking, the
program cache), ``mc_totals`` and ``mc_trajectories``."""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core  # before repro.telemetry: a cold import of it is circular
from repro.core import sim as r_sim
from repro.scenarios import montecarlo as r_mc
from repro.scenarios import registry as r_scenarios
from repro.scenarios import trajectory as r_traj
from repro.telemetry import builtin as r_det_builtin

from repro_torch.convert import predictor_from_jax
from repro_torch.core import sim as t_sim
from repro_torch.scenarios import montecarlo as t_mc
from repro_torch.scenarios import registry as t_scenarios
from repro_torch.scenarios import trajectory as t_traj
from repro_torch.scenarios.engine import CampaignEngine as TEngine
from repro_torch.scenarios.spec import FailureProcessSpec, ScenarioSpec
from repro_torch.telemetry import builtin as t_det_builtin
from repro_torch.launch.campaign import trial_mismatches

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# the family x strategy pairs of the reference's tests/test_trajectory.py
FAMILY_STRATEGY = [
    ("table1_periodic", "central_single"),
    ("table1_random", "core"),
    ("table2_random", "central_single"),
    ("rack_outage", "core"),
    ("cascade_spare", "core"),
    ("flaky_node", "central_single"),
    ("spare_exhaustion", "core"),
    ("checkpoint_storm", "central_single"),
    ("partition_split", "core"),
    ("multi_window_storm", "cold_restart"),
    ("mc_stress", "central_single"),
]
N_SEEDS = 6
N_FLEET_SEEDS = 2  # the engine pays ~1.5 s per 1088-host trial

_MICRO = {}


def micro_pair(n_nodes: int):
    """One MicroCosts measured by the reference, for both sides."""
    if n_nodes not in _MICRO:
        ref = r_sim.measure_micro("placentia", n_nodes=n_nodes)
        _MICRO[n_nodes] = (ref, t_sim.MicroCosts(**dataclasses.asdict(ref)))
    return _MICRO[n_nodes]


@pytest.fixture
def ref_replay(monkeypatch):
    """The reference replay imports ``jax.experimental.enable_x64``, which
    the installed jax has only as ``jax.enable_x64`` (ROADMAP Queue 3, item
    1). Restored for the test that asks for it and undone after it, so no
    other test run by the same worker sees it."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    return r_traj


@pytest.fixture(scope="module")
def predictors():
    ref = r_det_builtin._trained_predictor(0)
    port = predictor_from_jax({k: np.asarray(v) for k, v in ref.params.items()},
                              ref.mu, ref.sd, ref.threshold)
    return ref, port


def assert_bit_identical(want, got, ctx):
    assert set(got) == set(want), (ctx, sorted(set(got) ^ set(want)))
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert b.dtype == a.dtype and b.shape == a.shape, (ctx, k, b.dtype, a.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (ctx, k)


def port_replay(family, strategy, n_seeds, **kw):
    spec = t_scenarios.get(family)
    kw.setdefault("micro", micro_pair(spec.n_nodes)[1])
    return t_traj.replay_batch(spec, t_traj.compile_batch(spec, n_seeds), strategy,
                               device="cpu", **kw)


# ------------------------------------------- the fold against the reference ---
@pytest.mark.parametrize(
    "family,strategy,n_seeds,kw",
    [(f, s, N_SEEDS, {}) for f, s in FAMILY_STRATEGY]
    + [("fleet_stress", "central_single", N_FLEET_SEEDS, {}),
       ("fleet_stress", "core", N_FLEET_SEEDS, {}),
       ("partition_split", "hybrid", N_SEEDS, {"placement": "partition-aware"}),
       ("cascade_spare", "core", N_SEEDS, {"record_slots": True})],
    ids=lambda x: x if isinstance(x, str) else "-".join(f"{k}={v}" for k, v in x.items())
    if isinstance(x, dict) else str(x),
)
def test_replay_matches_reference_bitwise(family, strategy, n_seeds, kw, ref_replay):
    spec = r_scenarios.get(family)
    want = ref_replay.replay_batch(spec, ref_replay.compile_batch(spec, n_seeds), strategy,
                                   micro=micro_pair(spec.n_nodes)[0], **kw)
    got = port_replay(family, strategy, n_seeds, **kw)
    assert_bit_identical(want, got, (family, strategy))


@pytest.mark.parametrize("family", ["rack_outage", "mc_stress", "flaky_node"])
def test_compile_batch_matches_reference_bitwise(family):
    want = r_traj.compile_batch(r_scenarios.get(family), 8, base_seed=3)
    got = t_traj.compile_batch(t_scenarios.get(family), 8, base_seed=3)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and np.array_equal(a, b, equal_nan=True), f.name
        else:
            assert a == b, f.name


# ----------------------------------------------- the fold against the engine ---
@pytest.mark.parametrize("detector", ["oracle", "ml", "ewma_straggler"])
@pytest.mark.parametrize("family,strategy", [("mc_stress", "hybrid"), ("rack_outage", "agent"),
                                             ("multi_window_storm", "core"),
                                             ("straggler_drift", "decentral")])
def test_replay_matches_engine_under_detectors(family, strategy, detector, predictors):
    spec = t_scenarios.get(family)
    micro = micro_pair(spec.n_nodes)[1]
    det = t_det_builtin.MLDetector(predictor=predictors[1]) if detector == "ml" else detector
    out = t_traj.replay_batch(spec, t_traj.compile_batch(spec, 4), strategy, micro=micro,
                              detector=det, device="cpu")
    for k in range(4):
        res = TEngine(spec, strategy, micro=micro, seed=k, detector=det, device="cpu").run()
        assert trial_mismatches(out, k, res) == [], (family, strategy, detector, k)
        assert out["slowdown_s"][k] == res.slowdown_s


def test_hybrid_rules_bill_agent_migrations_like_the_engine():
    """Z > 10 on the star hub: Rules 1-3 route the hub's events to the
    agent mechanism, tracked through the dependency degrees."""
    spec = ScenarioSpec(
        name="hub_failure", n_nodes=12, n_spares=2, horizon_s=3600.0, repair_s=900.0,
        processes=[FailureProcessSpec("cascade", {"node": 11, "t": 600.0, "depth": 1,
                                                  "delay_s": 300.0, "predictable": True})],
    )
    micro = micro_pair(12)[1]
    out = t_traj.replay_batch(spec, t_traj.compile_batch(spec, 2), "hybrid", micro=micro,
                              device="cpu")
    res = TEngine(spec, "hybrid", micro=micro, seed=0, device="cpu").run()
    assert trial_mismatches(out, 0, res) == []
    assert res.reinstate_s > 2 * micro.predict_s


# ------------------------------------------------------------------ knobs ---
def test_fold_ties_resolve_as_the_reference():
    """First index on ties (argmin over float64, argmax over an int mask),
    Python's floor ``%`` at v = 0, and the two rankings on tied times."""
    x = torch.tensor([[3.0, 1.0, 1.0, np.inf], [np.inf, np.inf, np.inf, np.inf]],
                     dtype=torch.float64)
    assert torch.argmin(x, dim=1).tolist() == np.argmin(x.numpy(), axis=1).tolist() == [1, 0]
    m = torch.tensor([[False, True, True], [False, False, False]])
    assert torch.argmax(m.to(torch.int32), dim=1).tolist() == [1, 0]
    v = torch.tensor([[0], [5]], dtype=torch.int64)
    assert ((v - 1) % 6).tolist() == [[5], [4]] and ((v + 1) % 6).tolist() == [[1], [0]]
    rng = np.random.default_rng(0)
    for H in (7, 128, 129):
        ra = torch.from_numpy(rng.integers(0, 4, (5, H)).astype(np.float64))
        due = torch.from_numpy(rng.random((5, H)) < 0.5)
        ra = torch.where(due, ra, torch.tensor(np.inf, dtype=torch.float64))
        idx = torch.arange(H)
        keys = ra.numpy() + idx.numpy() * 1e-6  # earlier, then the lower host
        want = np.argsort(np.argsort(np.where(due.numpy(), keys, np.inf), axis=1, kind="stable"),
                          axis=1)
        got = t_traj._rank_due(ra, due, idx)
        assert np.array_equal(np.where(due.numpy(), got.numpy(), -1),
                              np.where(due.numpy(), want, -1)), H


@pytest.mark.parametrize("n_nodes", [120, 121])  # 128 and 129 hosts with the 8 spares
def test_pairwise_and_argsort_rankings_agree(n_nodes, monkeypatch):
    """Equal repair times on both sides of ``_PAIRWISE_RANK_MAX_HOSTS``: the
    replay is bit-identical whichever ranking runs."""
    spec = ScenarioSpec(
        name="tied_repairs", n_nodes=n_nodes, n_spares=8, horizon_s=4 * 3600.0,
        repair_s=1200.0, max_strikes=3,
        processes=[FailureProcessSpec("cascade", {"node": n, "t": 1800.0, "depth": 0})
                   for n in (3, 50, 90)]
        + [FailureProcessSpec("cascade", {"node": 10, "t": 2400.0, "depth": 1}),
           FailureProcessSpec("random", {})],
    )
    assert spec.n_nodes + spec.n_spares - t_traj._PAIRWISE_RANK_MAX_HOSTS in (0, 1)
    micro = micro_pair(4)[1]
    batch = t_traj.compile_batch(spec, 3)
    base = t_traj.replay_batch(spec, batch, "core", micro=micro, device="cpu")
    # three repairs complete at the same instant (t = 3000 s) on every seed
    assert base["survived"].all() and base["n_reprovisioned"].min() >= 3
    monkeypatch.setattr(t_traj, "_PAIRWISE_RANK_MAX_HOSTS",
                        1_000 if n_nodes + 8 > 128 else 0)
    t_traj._compiled_replayer.cache_clear()
    other = t_traj.replay_batch(spec, batch, "core", micro=micro, device="cpu")
    t_traj._compiled_replayer.cache_clear()
    assert_bit_identical(base, other, n_nodes)


@pytest.fixture(scope="module")
def fleet():
    spec = t_scenarios.get("fleet_stress")
    return spec, t_traj.compile_batch(spec, 4), micro_pair(spec.n_nodes)[1]


@pytest.mark.parametrize("tile_slots", [1, 64])
def test_replay_bit_identical_across_tile_sizes(fleet, tile_slots):
    spec, batch, micro = fleet
    want = t_traj.replay_batch(spec, batch, "core", micro=micro, device="cpu")
    got = t_traj.replay_batch(spec, batch, "core", micro=micro, tile_slots=tile_slots,
                              device="cpu", record_slots=False)
    assert_bit_identical(want, got, tile_slots)


def test_replay_bit_identical_across_device_counts(fleet):
    spec, batch, micro = fleet
    want = t_traj.replay_batch(spec, batch, "hybrid", micro=micro, n_devices=1, device="cpu")
    got = t_traj.replay_batch(spec, batch, "hybrid", micro=micro, n_devices=2, device="cpu")
    assert_bit_identical(want, got, "n_devices=2")
    with pytest.raises(ValueError, match="divide"):
        t_traj.replay_batch(spec, batch, "hybrid", micro=micro, n_devices=3, device="cpu")


def test_more_cards_than_the_host_has_raises(fleet, monkeypatch):
    spec, batch, micro = fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="available CUDA devices"):
        t_traj.replay_program(spec, batch, "core", micro=micro, n_devices=2, device="cuda")
    assert t_traj.default_seed_devices(4) == 1


def test_replay_without_cuda_raises(fleet, monkeypatch):
    spec, batch, micro = fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_traj.replay_batch(spec, batch, "core", micro=micro)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_mc.mc_totals(t_mc.MCParams(3600.0, 3600.0, 1, 1.0, 1.0), n_seeds=4)


def test_cost_tables_of_one_structure_share_one_program(fleet):
    """N cost tables of one structure (the strategy's, priced from N
    micro-cost records): one program build and N - 1 cache hits."""
    spec, batch, micro = fleet
    micros = [dataclasses.replace(micro, core_reinstate_s=micro.core_reinstate_s * (1 + i))
              for i in range(4)]
    t_traj._compiled_replayer.cache_clear()
    totals = [t_traj.replay_batch(spec, batch, "core", micro=m, device="cpu")["total_s"]
              for m in micros]
    assert t_traj.replay_cache_stats() == {"hits": 3, "misses": 1, "programs": 1}
    assert len({tuple(t) for t in totals}) == 4  # the numbers really differ


def test_replay_rejects_what_it_cannot_run():
    spec = t_scenarios.get("rack_outage")
    with pytest.raises(ValueError, match="placement"):
        port_replay("rack_outage", "core", 2, placement="voodoo")
    churn = t_scenarios.get("decode_fleet_churn")
    out = t_traj.replay_batch(churn, t_traj.compile_batch(churn, 2), "core", device="cpu")
    assert {"slo_p50_s", "slo_p99_s", "slo_dropped", "slo_availability"} <= set(out)
    assert spec.traffic is None


# ------------------------------------------------------------ monte-carlo ---
@pytest.mark.parametrize("family,strategy", [("table1_periodic", "central_single"),
                                             ("table1_random", "core"),
                                             ("table2_random", "hybrid")])
def test_mc_totals_deterministic_branch_equal(family, strategy):
    ref_micro, t_micro = micro_pair(4)
    want_p = r_mc.params_from_scenario(r_scenarios.get(family), strategy, ref_micro)
    got_p = t_mc.params_from_scenario(t_scenarios.get(family), strategy, t_micro)
    assert dataclasses.asdict(got_p) == dataclasses.asdict(want_p)
    want = r_mc.mc_totals(want_p, n_seeds=16)
    got = t_mc.mc_totals(got_p, n_seeds=16, device="cpu")
    assert got.pop("totals").tolist() == want.pop("totals").tolist()
    assert got == want
    assert np.array_equal(t_mc.python_loop_baseline(got_p, 5), r_mc.python_loop_baseline(want_p, 5))


def test_mc_totals_random_branch_agrees_statistically():
    """The draws differ (threefry at float32 there, a torch generator at
    float64 here): means within 4 combined standard errors, stds within
    5 %, at 4000 seeds of table1_random."""
    ref_micro, t_micro = micro_pair(4)
    n = 4000
    want = r_mc.mc_totals(r_mc.params_from_scenario(r_scenarios.get("table1_random"),
                                                    "central_single", ref_micro), n_seeds=n)
    got = t_mc.mc_totals(t_mc.params_from_scenario(t_scenarios.get("table1_random"),
                                                   "central_single", t_micro), n_seeds=n,
                         device="cpu")
    assert got["totals"].dtype == np.float64 and got["totals"].shape == (n,)
    se = np.hypot(got["std_s"], want["std_s"]) / np.sqrt(n)
    assert abs(got["mean_s"] - want["mean_s"]) <= 4 * se
    assert got["std_s"] == pytest.approx(want["std_s"], rel=0.05)
    again = t_mc.mc_totals(t_mc.params_from_scenario(t_scenarios.get("table1_random"),
                                                     "central_single", t_micro), n_seeds=n,
                           device="cpu")
    assert np.array_equal(again["totals"], got["totals"])  # seeded


def test_mc_trajectories_matches_reference(ref_replay):
    family = "flaky_node"
    ref_micro, t_micro = micro_pair(4)
    want = r_mc.mc_trajectories(r_scenarios.get(family), "hybrid", n_seeds=16, micro=ref_micro)
    got = t_mc.mc_trajectories(family, "hybrid", n_seeds=16, micro=t_micro, device="cpu")
    assert got["frames"] == want["frames"]
    for k in ("p5_s", "p50_s", "p95_s", "mean_s", "std_s", "survival_rate", "counters",
              "n_seeds", "workload", "scenario", "mean_failed_at_s"):
        assert got[k] == want[k], k
    assert_bit_identical(want["trials"], got["trials"], family)
