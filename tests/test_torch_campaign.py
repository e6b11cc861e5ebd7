"""The campaign path of the port against the JAX reference: telemetry
detectors, straggler handling, workloads, the scenario DSL and registry,
and ``CampaignEngine`` records under one pinned MicroCosts."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # before repro.telemetry: a cold import of it is circular
from repro.core import sim as r_sim
from repro.core import straggler as r_straggler
from repro.roofline import analysis as r_analysis
from repro.scenarios import registry as r_scenarios
from repro.scenarios.engine import CampaignEngine as REngine
from repro.scenarios.spec import ScenarioSpec as RSpec
from repro.scenarios.spec import degrade_slowdown_s as r_slowdown
from repro.scenarios.trajectory import compile_tape as r_compile_tape
from repro.telemetry import builtin as r_det_builtin
from repro.telemetry import frame as r_frame
from repro.telemetry import registry as r_detectors
from repro.workloads import registry as r_workloads

from repro_torch.convert import predictor_from_jax
from repro_torch.core import sim as t_sim
from repro_torch.core import straggler as t_straggler
from repro_torch.launch import campaign as t_campaign
from repro_torch.launch import genome as t_genome_launch
from repro_torch.roofline import analysis as t_analysis
from repro_torch.scenarios import registry as t_scenarios
from repro_torch.scenarios.engine import CampaignEngine as TEngine
from repro_torch.scenarios.spec import ScenarioSpec as TSpec
from repro_torch.scenarios.spec import degrade_slowdown_s as t_slowdown
from repro_torch.scenarios.trajectory import compile_tape as t_compile_tape
from repro_torch.telemetry import builtin as t_det_builtin
from repro_torch.telemetry import frame as t_frame
from repro_torch.telemetry import registry as t_detectors
from repro_torch.telemetry import resolve as t_resolve_detector
from repro_torch.workloads import registry as t_workloads
from repro_torch.workloads import resolve as t_resolve_workload
from repro_torch.workloads.base import _interp

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# the family x strategy pairs of the reference's tests/test_trajectory.py
# (every billing mode and process kind), plus the degrade family and the
# genome-workload family
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
    ("straggler_drift", "hybrid"),
    ("genome_campaign", "hybrid"),
]
ENGINE_SEEDS = 3
LLM_FAMILIES = ("llm_pretrain_storm", "decode_fleet_churn")

_MICRO = {}


def micro_pair(family: str):
    """One MicroCosts measured by the reference, for both sides: the
    family's workload's (the genome_search workload calibrates by wall
    clock, so its record is pinned too)."""
    spec = r_scenarios.get(family)
    key = (spec.workload, spec.n_nodes)
    if key not in _MICRO:
        ref = r_workloads.get(spec.workload).micro("placentia", n_nodes=spec.n_nodes)
        _MICRO[key] = (ref, t_sim.MicroCosts(**dataclasses.asdict(ref)))
    return _MICRO[key]


@pytest.fixture(scope="module")
def predictors():
    """The reference's trained ML predictor and the port's copy of its
    weights (``convert.predictor_from_jax``)."""
    ref = r_det_builtin._trained_predictor(0)
    port = predictor_from_jax({k: np.asarray(v) for k, v in ref.params.items()},
                              ref.mu, ref.sd, ref.threshold)
    return ref, port


def port_detector(name, predictors):
    if name == "ml":
        return t_det_builtin.MLDetector(predictor=predictors[1])
    return t_resolve_detector(name, "cpu")


# ------------------------------------------------------------- telemetry ---
def test_detector_registry_matches_reference():
    assert t_detectors.names() == r_detectors.names() == ["oracle", "ml", "ewma_straggler"]
    assert t_detectors.get_class("predictor") is t_det_builtin.MLDetector
    assert "composite" not in t_detectors.names()
    assert t_detectors.get_class("ewma_straggler").flags_stragglers
    with pytest.raises(KeyError, match="unknown detector"):
        t_detectors.get("voodoo")


def test_resolve_places_a_named_detector_on_the_device():
    det = t_resolve_detector("ml", "cpu")
    assert isinstance(det, t_det_builtin.MLDetector) and det.device == "cpu"
    inst = t_det_builtin.OracleDetector()
    assert t_resolve_detector(inst, "cpu") is inst


@pytest.mark.parametrize("family", ["rack_outage", "mc_stress", "flaky_node"])
def test_synth_event_telemetry_bitwise(family):
    spec = r_scenarios.get(family)
    for seed in range(3):
        tape = r_compile_tape(spec, seed)
        args = (tape.times, tape.predictable, tape.rack_corr, seed)
        want = r_frame.synth_event_telemetry(*args)
        got = t_frame.synth_event_telemetry(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("detector", ["oracle", "ml", "ewma_straggler"])
def test_verdict_tapes_match_reference(detector, predictors):
    """Equal verdicts on every slot; a flip on a borderline score would be
    named here with both scores and the threshold."""
    ref_det = r_detectors.get(detector)
    det = port_detector(detector, predictors)
    for family in ("rack_outage", "mc_stress", "multi_window_storm"):
        spec = r_scenarios.get(family)
        for seed in range(4):
            tape = r_compile_tape(spec, seed)
            args = (spec, tape.times, tape.predictable, tape.rack_corr, seed)
            want, want_lead = ref_det.verdict_tape(*args)
            got, got_lead = det.verdict_tape(*args)
            flips = np.flatnonzero(got != want)
            if detector == "ml" and flips.size:
                feats = t_frame.synth_event_telemetry(*args[1:])
                named = [(int(j), float(predictors[0].score(feats[j])),
                          float(predictors[1].score(feats[j])), predictors[0].threshold)
                         for j in flips]
                pytest.fail(f"{family} seed {seed}: verdicts flip (slot, ref score, port "
                            f"score, threshold): {named}")
            assert np.array_equal(got, want), (family, seed)
            np.testing.assert_allclose(got_lead, want_lead, rtol=0, atol=1e-4)


def test_straggler_helpers_match_reference():
    rng = np.random.default_rng(3)
    t_det = t_straggler.StragglerDetector(n_hosts=6)
    r_det = r_straggler.StragglerDetector(n_hosts=6)
    for step in range(20):
        lat = 1.0 + 0.05 * rng.random(6)
        lat[4] += 0.1 * step
        assert t_det.observe(lat.copy()) == r_det.observe(lat.copy())
    assert np.array_equal(t_det.mean, r_det.mean) and np.array_equal(t_det.var, r_det.var)
    for split, bad in (([8] * 6, [4]), ([1, 1, 1], [0]), ([3, 0, 5], [2, 0])):
        assert t_straggler.mitigate(split, bad) == r_straggler.mitigate(split, bad)
    speeds = np.asarray([1.0, 0.4, 1.0, 0.9])
    assert t_straggler.sync_step_time([8, 8, 8, 8], speeds) == \
        r_straggler.sync_step_time([8, 8, 8, 8], speeds)


@pytest.mark.parametrize("family", ["straggler_drift", "fleet_stress"])
@pytest.mark.parametrize("mitigate", [False, True])
def test_degrade_slowdown_matches_reference(family, mitigate):
    want = r_slowdown(r_scenarios.get(family), mitigate_stragglers=mitigate)
    assert want > 0
    assert t_slowdown(t_scenarios.get(family), mitigate_stragglers=mitigate) == want


# ------------------------------------------------------------- workloads ---
def test_workload_registry_and_the_llm_workloads_raise():
    """Every reference workload is registered, in the reference's order; the
    LLM workloads resolve (they raised until they were ported) and an
    unknown name still raises."""
    assert t_workloads.names() == r_workloads.names() == [
        "analytic", "genome_search", "train_llm", "serve_decode"]
    assert t_workloads.get_class("paper").name == "analytic"
    assert t_workloads.get_class("genome").name == "genome_search"
    for name, canonical in (("train_llm", "train_llm"), ("train", "train_llm"),
                            ("serve_decode", "serve_decode"), ("serve", "serve_decode")):
        wl = t_resolve_workload(name, device="cpu")
        assert wl.name == canonical and wl.hw == t_analysis.H100_SXM and wl.arch == "gemma-2b"
    with pytest.raises(KeyError, match="unknown workload"):
        t_workloads.get("voodoo")
    wl = t_resolve_workload(None, t_scenarios.get("genome_campaign"), device="cpu")
    assert wl.name == "genome_search" and wl.device == "cpu"


@pytest.mark.parametrize("n_nodes", [4, 24, 1024])
def test_analytic_cost_table_matches_reference(n_nodes):
    want = r_workloads.get("analytic").cost_table("placentia", n_nodes=n_nodes)
    got = t_workloads.get("analytic").cost_table("placentia", n_nodes=n_nodes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ref_micro = r_workloads.get("analytic").micro("placentia", n_nodes=n_nodes)
    assert dataclasses.asdict(ref_micro) == dataclasses.asdict(
        r_sim.measure_micro("placentia", n_nodes=n_nodes))


def test_cost_table_at_equals_np_interp():
    table = t_workloads.get("analytic").cost_table("placentia", n_nodes=4)
    grid = np.asarray(table.n_shards, np.float64)
    q = np.concatenate([grid, (grid[:-1] + grid[1:]) / 2, [0.5, 1.5, 3.0, 700.0, 1024.0, 4096.0],
                        np.random.default_rng(0).uniform(0.0, 1500.0, 64)])
    got = table.at(q)
    surf = table.surfaces()
    assert surf["n_shards"].dtype == torch.float64
    for f in table.SURFACE_FIELDS:
        want = np.interp(q, grid, np.asarray(getattr(table, f), np.float64))
        assert got[f].dtype == torch.float64
        assert np.array_equal(got[f].numpy(), want), f
        assert np.array_equal(surf[f].numpy(), np.asarray(getattr(table, f))), f
    assert float(table.step_time(4)) == table.step_time_s[2]
    tied = torch.tensor([1.0, 1.0, 1.0, 3.0], dtype=torch.float64)
    assert _interp(torch.tensor([1.0, 2.0]), tied, torch.arange(4.0)).tolist() == \
        np.interp([1.0, 2.0], tied.numpy(), np.arange(4.0)).tolist()


LLM_ARCHS = ("gemma-2b", "rwkv6-1.6b", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_roofline_param_count_and_flops_match_reference(arch):
    from repro.configs import SHAPES as R_SHAPES, get_arch as r_get_arch

    from repro_torch.configs import SHAPES as T_SHAPES, get_arch as t_get_arch

    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    r_cfg, t_cfg = r_get_arch(arch), t_get_arch(arch)
    assert t_analysis.param_count(t_cfg) == r_analysis.param_count(r_cfg)
    for shape in R_SHAPES:
        assert t_analysis.model_flops(t_cfg, T_SHAPES[shape]) == \
            r_analysis.model_flops(r_cfg, R_SHAPES[shape])
    hw = t_analysis.HW(**dataclasses.asdict(r_analysis.V5E))
    for args in ((1e15, 2e10, 0.0), (3e12, 5e11, 4e9), (0.0, 0.0, 0.0)):
        assert t_analysis.roofline_terms(*args, hw) == r_analysis.roofline_terms(*args)


@pytest.mark.parametrize("n_nodes", [4, 8, 256])
@pytest.mark.parametrize("workload", ["train_llm", "serve_decode"])
def test_llm_cost_tables_bitwise_under_the_reference_record(workload, n_nodes):
    """Under the reference's device record the LLM workloads' cost tables
    are the reference's, bit for bit; the port's own record, the H100's,
    changes the step surface and nothing else."""
    hw = t_analysis.HW(**dataclasses.asdict(r_analysis.V5E))
    for arch in LLM_ARCHS:
        want = r_workloads.get(workload, arch=arch).cost_table("placentia", n_nodes=n_nodes)
        got = t_workloads.get(workload, arch=arch, hw=hw).cost_table("placentia", n_nodes=n_nodes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (workload, arch)
        h100 = t_workloads.get(workload, arch=arch).cost_table("placentia", n_nodes=n_nodes)
        assert h100.step_time_s != want.step_time_s, (workload, arch)
        assert dataclasses.asdict(dataclasses.replace(h100, step_time_s=want.step_time_s)) == \
            dataclasses.asdict(want)
        assert all(0 < a <= b for a, b in zip(h100.step_time_s, want.step_time_s))
    assert r_analysis.V5E != t_analysis.H100_SXM  # no TPU record in the port
    assert t_workloads.get(workload, hw=hw) == t_workloads.get(workload, hw=hw)
    assert t_workloads.get(workload, hw=hw) != t_workloads.get(workload)
    assert len({t_workloads.get(workload, hw=hw), t_workloads.get(workload, hw=hw)}) == 1
    with pytest.raises(TypeError):
        t_analysis.HW()  # the record carries no default peaks


def test_genome_workload_calibrates_on_its_device():
    wl = t_resolve_workload("genome_search", device="cpu")
    table = wl.cost_table("placentia", n_nodes=4)
    assert table.workload == "genome_search" and table.z == 4
    assert all(a > b > 0 for a, b in zip(table.step_time_s, table.step_time_s[1:]))
    assert table.payload_bytes < table.state_bytes_per_shard
    ref = r_workloads.get("genome_search").cost_table("placentia", n_nodes=4)
    assert (table.state_bytes_per_shard, table.ckpt_write_s) == \
        (ref.state_bytes_per_shard, ref.ckpt_write_s)
    assert wl.measured_step_surface() is None  # no kernel hot path


# ------------------------------------------------------ spec and registry ---
def test_scenario_registry_matches_reference():
    assert list(t_scenarios._REGISTRY) == list(r_scenarios._REGISTRY)
    assert t_scenarios.names() == r_scenarios.names()
    assert len(t_scenarios.names()) == 17


@pytest.mark.parametrize("family", r_scenarios.names())
def test_spec_dict_round_trip_matches_reference(family):
    want = r_scenarios.get(family).to_dict()
    spec = t_scenarios.get(family)
    assert spec.to_dict() == want
    again = TSpec.from_dict(want)
    assert again.to_dict() == want
    assert RSpec.from_dict(spec.to_dict()).to_dict() == want
    assert again.partition_timeline() == spec.partition_timeline()
    assert again.degrade_timeline() == spec.degrade_timeline()


@pytest.mark.parametrize("family", r_scenarios.names())
def test_tapes_match_reference_bitwise(family):
    spec_r, spec_t = r_scenarios.get(family), t_scenarios.get(family)
    for seed in range(2):
        want, got = r_compile_tape(spec_r, seed), t_compile_tape(spec_t, seed)
        assert got.causes == want.causes and got.partition_changes == want.partition_changes
        for f in ("times", "victim", "parent", "predictable", "during_ckpt", "repair_draws",
                  "rack_corr", "part_active", "part_comp"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (family, seed, f)


# ---------------------------------------------------------------- engine ---
@pytest.mark.parametrize("family,strategy", FAMILY_STRATEGY)
def test_engine_records_match_reference(family, strategy):
    ref_micro, t_micro = micro_pair(family)
    spec_r, spec_t = r_scenarios.get(family), t_scenarios.get(family)
    for seed in range(ENGINE_SEEDS):
        want = REngine(spec_r, strategy, micro=ref_micro, seed=seed).run()
        got = TEngine(spec_t, strategy, micro=t_micro, seed=seed, device="cpu").run()
        assert got.to_dict() == want.to_dict(), (family, strategy, seed)
        assert got.events == want.events and got.slowdown_s == want.slowdown_s


@pytest.mark.parametrize("detector", ["ml", "ewma_straggler"])
@pytest.mark.parametrize("family,strategy", [("mc_stress", "hybrid"), ("rack_outage", "agent"),
                                             ("straggler_drift", "core")])
def test_engine_records_match_reference_under_detectors(family, strategy, detector, predictors):
    ref_micro, t_micro = micro_pair(family)
    spec_r, spec_t = r_scenarios.get(family), t_scenarios.get(family)
    for seed in range(ENGINE_SEEDS):
        want = REngine(spec_r, strategy, micro=ref_micro, seed=seed, detector=detector).run()
        got = TEngine(spec_t, strategy, micro=t_micro, seed=seed,
                      detector=port_detector(detector, predictors), device="cpu").run()
        assert got.to_dict() == want.to_dict(), (family, strategy, detector, seed)


def test_engine_raises_for_what_waits_for_item_8():
    """Nothing waits any more: the trace, the traffic families and the LLM
    workloads run; an unknown approach still raises."""
    spec = t_scenarios.get("flaky_node")
    assert TEngine(spec, "core", trace=True, seed=0, device="cpu").run().trace.events
    churn = TEngine(t_scenarios.get("decode_fleet_churn"), "core", seed=0, device="cpu").run()
    assert churn.workload == "serve_decode" and 0.0 < churn.slo_availability <= 1.0
    storm = TEngine(t_scenarios.get("llm_pretrain_storm"), "core", seed=0, device="cpu").run()
    assert storm.workload == "train_llm" and storm.slo_p99_s is None
    with pytest.raises(ValueError, match="approach"):
        TEngine(spec, "voodoo", device="cpu")


def test_scenario_totals_prices_engine_families_by_name():
    ref_micro, t_micro = micro_pair("genome_campaign")
    want = r_sim.scenario_totals("genome_campaign", micro=ref_micro)
    got = t_sim.scenario_totals("genome_campaign", micro=t_micro, device="cpu")
    assert got == want and {v["source"] for v in got.values()} == {"engine"}


# ----------------------------------------------------------- entry points ---
def test_campaign_launcher_on_the_cpu(capsys):
    rc = t_campaign.main(["--device", "cpu", "--scenario", "flaky_node", "--strategy", "all",
                          "--seeds", "8", "--json"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert [c["strategy"] for c in res["cells"]] == t_campaign.strategies.names()
    assert all(c["ok"] and c["checked"] == 4 and c["device"] == "cpu" for c in res["cells"])


def test_campaign_launcher_lists_the_waiting_families(capsys):
    """``--scenario all`` runs all 17 families and lists none as waiting;
    the traffic family prints its SLO line and equals the engine's bills."""
    rc = t_campaign.main(["--device", "cpu", "--scenario", "all", "--strategy", "core",
                          "--seeds", "2", "--check-seeds", "1", "--json"])
    out = capsys.readouterr().out
    assert rc == 0 and "waiting" not in out
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert [c["scenario"] for c in res["cells"]] == t_scenarios.names()
    assert set(LLM_FAMILIES) <= {c["scenario"] for c in res["cells"]}
    slo = {c["scenario"]: c["slo"] for c in res["cells"] if c["slo"] is not None}
    assert list(slo) == ["decode_fleet_churn"] and slo["decode_fleet_churn"]["n_seeds"] == 2
    assert "SLO under static" in out


def test_campaign_launcher_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_campaign.main(["--scenario", "flaky_node", "--seeds", "2"])


def test_trial_check_names_the_fields_that_differ():
    spec = t_scenarios.get("flaky_node")
    res = TEngine(spec, "core", seed=0, device="cpu").run()
    out = {f: np.asarray([getattr(res, f)]) for f in t_campaign.COUNTERS + t_campaign.COSTS}
    out.update(survived=np.asarray([True]), total_s=np.asarray([res.total_s]),
               failed_at_s=np.asarray([np.nan]))
    assert t_campaign.trial_mismatches(out, 0, res) == []
    out["lost_s"] = out["lost_s"] + 1e-3
    out["n_events"] = out["n_events"] + 1
    out["total_s"] = out["total_s"] * (1 + 1e-8)
    assert t_campaign.trial_mismatches(out, 0, res) == ["n_events", "lost_s", "total_s"]


def test_genome_launcher_campaign_section():
    """The example's campaign section: genome_campaign under the genome
    workload, checkpointing dearer than every multi-agent strategy."""
    res = t_genome_launch.campaign(["central_single", "agent", "core", "hybrid"], device="cpu")
    assert res["ok"] and res["workload"] == "genome_search"
    ovh = {r["strategy"]: r["overhead_pct"] for r in res["rows"]}
    assert ovh["central_single"] > max(ovh["agent"], ovh["core"], ovh["hybrid"])
    assert all(r["migrations"] > 0 for r in res["rows"] if r["strategy"] != "central_single")
