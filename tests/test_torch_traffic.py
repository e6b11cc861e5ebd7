"""Serving traffic on the port against the reference: the autoscaler
registry, ``bill_slo`` on the same tapes, and the request-level SLO bills
of ``decode_fleet_churn`` — bitwise between the port's ``CampaignEngine``
and the port's replay fold, and bitwise against the reference's engine
under one pinned MicroCosts and the reference's own device record."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.telemetry: a cold import of it is circular)
from repro.roofline import analysis as r_analysis
from repro.scenarios import registry as r_scenarios
from repro.scenarios.engine import CampaignEngine as REngine
from repro.scenarios.trajectory import compile_tape as r_compile_tape
from repro.strategies import CostContext as RCostContext
from repro.strategies import registry as r_strategies
from repro.traffic import registry as r_traffic
from repro.traffic.slo import bill_slo as r_bill_slo
from repro.workloads import registry as r_workloads

from repro_torch.core import sim as t_sim
from repro_torch.roofline import analysis as t_analysis
from repro_torch.scenarios import montecarlo as t_mc
from repro_torch.scenarios import registry as t_scenarios
from repro_torch.scenarios import trajectory as t_traj
from repro_torch.scenarios.engine import CampaignEngine as TEngine
from repro_torch.strategies import CostContext as TCostContext
from repro_torch.strategies import registry as t_strategies
from repro_torch.traffic import Autoscaler, CapacityPlan
from repro_torch.traffic import registry as t_traffic
from repro_torch.traffic.slo import bill_slo as t_bill_slo
from repro_torch.workloads import registry as t_workloads

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

SLO_KEYS = ("slo_p50_s", "slo_p99_s", "slo_dropped", "slo_availability")
AUTOSCALERS = ("static", "shrink_to_fit", "burst_scale_out")
N_SEEDS = 2
FAMILY = "decode_fleet_churn"
# the reference's device record, made in this process only: the port has none
REF_HW = t_analysis.HW(**dataclasses.asdict(r_analysis.V5E))

_MICRO = {}


def micro_pair():
    """One MicroCosts measured by the reference for ``serve_decode`` on the
    family's 256 nodes, for both sides."""
    if not _MICRO:
        ref = r_workloads.get("serve_decode").micro("placentia", n_nodes=256)
        _MICRO["pair"] = (ref, t_sim.MicroCosts(**dataclasses.asdict(ref)))
    return _MICRO["pair"]


def same(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.fixture(scope="module")
def churn():
    spec = t_scenarios.get(FAMILY)
    return spec, t_traj.compile_batch(spec, N_SEEDS)


# ------------------------------------------------------------- registry ---
def test_autoscaler_registry_roundtrip():
    assert t_traffic.names() == r_traffic.names() == list(AUTOSCALERS)
    for name in AUTOSCALERS:
        cls = t_traffic.get_class(name)
        assert issubclass(cls, Autoscaler) and cls.name == name
        assert cls.continue_after_strand == r_traffic.get_class(name).continue_after_strand
    with pytest.raises(KeyError, match="unknown autoscaler"):
        t_traffic.get("voodoo")

    @t_traffic.register("half_fleet", aliases=("half",))
    class HalfFleet(Autoscaler):
        def plan(self, tl):
            return CapacityPlan(capacity_rps=0.5 * tl.n_shards0 * tl.per_shard_rps(tl.n_shards0)
                                * np.ones_like(tl.start_s))

    try:
        assert t_traffic.names()[-1] == "half_fleet"
        assert t_traffic.get_class("half") is HalfFleet
        with pytest.raises(KeyError, match="already registered"):
            t_traffic.register("static")(HalfFleet)
        with pytest.raises(TypeError, match="not an Autoscaler"):
            t_traffic.register("nope")(object)
    finally:
        t_traffic.unregister("half_fleet")
    assert "half_fleet" not in t_traffic.names() and "half_fleet" not in r_traffic.names()


# ------------------------------------------------------------ bill_slo ---
@pytest.mark.parametrize("autoscaler", AUTOSCALERS)
@pytest.mark.parametrize("strategy", ["central_single", "agent", "core", "hybrid",
                                      "cold_restart"])
def test_bill_slo_bitwise_equal_to_reference(strategy, autoscaler):
    """The same tapes, verdicts and cost tables give the same four numbers
    (and the same policy counters), bit for bit."""
    r_micro, t_micro = micro_pair()
    spec_r, spec_t = r_scenarios.get(FAMILY), t_scenarios.get(FAMILY)
    period_h = spec_r.period_s / 3600.0
    r_table = r_strategies.get(strategy).cost_table(RCostContext(micro=r_micro, period_h=period_h))
    t_table = t_strategies.get(strategy).cost_table(TCostContext(micro=t_micro, period_h=period_h))
    r_wtable = r_workloads.get("serve_decode").cost_table("placentia", n_nodes=256)
    t_wtable = t_workloads.get("serve_decode", hw=REF_HW).cost_table("placentia", n_nodes=256)
    assert dataclasses.asdict(t_wtable) == dataclasses.asdict(r_wtable)
    rng = np.random.default_rng(7)
    for seed in range(N_SEEDS):
        tape = r_compile_tape(spec_r, seed)
        verdicts = tape.predictable & (rng.random(tape.n_slots) < 0.8)
        args = dict(times=tape.times, victim=tape.victim, parent=tape.parent,
                    predictable=tape.predictable, verdicts=verdicts, draws=tape.repair_draws,
                    seed=seed, autoscaler=autoscaler)
        want = r_bill_slo(spec_r, table=r_table, wtable=r_wtable, **args)
        got = t_bill_slo(spec_t, table=t_table, wtable=t_wtable, **args)
        for f in ("autoscaler", "offered", "n_rebalances", "n_scaleouts"):
            assert getattr(got, f) == getattr(want, f), (strategy, autoscaler, seed, f)
        for f in ("p50_s", "p99_s", "dropped", "availability"):
            assert same(getattr(got, f), getattr(want, f)), (strategy, autoscaler, seed, f)


def test_bill_slo_refuses_what_the_reference_refuses():
    _, t_micro = micro_pair()
    spec = t_scenarios.get("flaky_node")
    table = t_strategies.get("core").cost_table(TCostContext(micro=t_micro, period_h=1.0))
    wtable = t_workloads.get("serve_decode").cost_table("placentia", n_nodes=4)
    empty = np.zeros(0)
    with pytest.raises(ValueError, match="no traffic"):
        t_bill_slo(spec, times=empty, victim=empty, parent=empty, predictable=empty,
                   verdicts=empty, draws=empty, table=table, wtable=wtable, seed=0)


# ---------------------------------------------- engine == fold, the port ---
@pytest.mark.parametrize("autoscaler", AUTOSCALERS)
@pytest.mark.parametrize("strategy", t_strategies.names())
def test_engine_fold_slo_parity(churn, strategy, autoscaler):
    spec, batch = churn
    _, t_micro = micro_pair()
    out = t_traj.replay_batch(spec, batch, strategy, micro=t_micro, autoscaler=autoscaler,
                              device="cpu")
    for k in SLO_KEYS:
        assert out[k].dtype == np.float64 and out[k].shape == (N_SEEDS,)
    for s in range(N_SEEDS):
        res = TEngine(spec, strategy, micro=t_micro, seed=s, autoscaler=autoscaler,
                      device="cpu").run()
        assert res.autoscaler == autoscaler
        for k in SLO_KEYS:
            assert same(float(out[k][s]), getattr(res, k)), (strategy, autoscaler, s, k)


@pytest.mark.parametrize("autoscaler", ["static", "shrink_to_fit"])
def test_engine_fold_slo_parity_ml_detector(churn, autoscaler):
    """The noisy detector changes which failures are predicted; verdicts feed
    the serving outage model, so parity must survive it too."""
    spec, batch = churn
    _, t_micro = micro_pair()
    for strategy in ("central_single", "agent", "cold_restart"):
        out = t_traj.replay_batch(spec, batch, strategy, micro=t_micro, detector="ml",
                                  autoscaler=autoscaler, device="cpu")
        for s in range(N_SEEDS):
            res = TEngine(spec, strategy, micro=t_micro, seed=s, detector="ml",
                          autoscaler=autoscaler, device="cpu").run()
            for k in SLO_KEYS:
                assert same(float(out[k][s]), getattr(res, k)), (strategy, autoscaler, s, k)


# ------------------------------------------- port engine == reference's ---
@pytest.mark.parametrize("autoscaler", AUTOSCALERS)
@pytest.mark.parametrize("strategy", ["central_single", "agent", "core", "cold_restart"])
def test_engine_slo_matches_reference_engine(strategy, autoscaler):
    r_micro, t_micro = micro_pair()
    spec_r, spec_t = r_scenarios.get(FAMILY), t_scenarios.get(FAMILY)
    wl = t_workloads.get("serve_decode", hw=REF_HW)
    for seed in range(N_SEEDS):
        want = REngine(spec_r, strategy, micro=r_micro, seed=seed, autoscaler=autoscaler).run()
        got = TEngine(spec_t, strategy, micro=t_micro, seed=seed, autoscaler=autoscaler,
                      workload=wl, device="cpu").run()
        assert got.to_dict() == want.to_dict(), (strategy, autoscaler, seed)
        assert got.events == want.events and got.autoscaler == want.autoscaler
        for k in SLO_KEYS:
            assert same(getattr(got, k), getattr(want, k)), (strategy, autoscaler, seed, k)


def test_device_record_changes_the_bills(churn):
    """The port's default record is the H100's: the step surface, and with
    it the SLO bills, differ from those under the reference's record."""
    spec, batch = churn
    _, t_micro = micro_pair()
    h100 = t_traj.replay_batch(spec, batch, "agent", micro=t_micro, device="cpu")
    ref = t_traj.replay_batch(spec, batch, "agent", micro=t_micro, device="cpu",
                              workload=t_workloads.get("serve_decode", hw=REF_HW))
    assert np.array_equal(h100["total_s"], ref["total_s"])  # makespan: hw-free
    assert not np.array_equal(h100["slo_p50_s"], ref["slo_p50_s"])


# ------------------------------------------------------ the other views ---
def test_slo_fields_absent_without_traffic():
    _, t_micro = micro_pair()
    spec = t_scenarios.get("flaky_node")
    res = TEngine(spec, "agent", seed=0, device="cpu").run()
    assert res.slo_p99_s is None and res.slo_availability is None
    assert "slo_p99_s" not in res.to_dict()
    out = t_traj.replay_batch(spec, t_traj.compile_batch(spec, 2), "agent", device="cpu")
    assert "slo_p99_s" not in out


def test_mc_trajectories_attaches_slo_block(churn):
    spec, batch = churn
    _, t_micro = micro_pair()
    mc = t_mc.mc_trajectories(spec, "agent", n_seeds=N_SEEDS, batch=batch, micro=t_micro,
                              autoscaler="burst_scale_out", device="cpu")
    slo = mc["slo"]
    assert slo["n_seeds"] == N_SEEDS and slo["n_with_traffic"] == N_SEEDS
    assert slo["p99_s"]["mean"] > 0 and 0.0 < slo["availability_min"] <= 1.0
    plain = t_mc.mc_trajectories("flaky_node", "agent", n_seeds=2, device="cpu")
    assert "slo" not in plain
