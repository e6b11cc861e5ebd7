"""Observability on the port against the reference: the engine's structured
trace against the trace rebuilt from the port's replay fold on every
family, the port's engine trace against the reference engine's, the
Chrome-trace export, the timing idiom (``timed``/``stopwatch`` and the
``utils.timing`` re-exports), ``profile_replay`` and the measured step
surfaces (plain versions on the CPU)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.telemetry: a cold import of it is circular)
from repro.obs import profile as r_profile
from repro.roofline import analysis as r_analysis
from repro.scenarios import registry as r_scenarios
from repro.scenarios.engine import CampaignEngine as REngine
from repro.workloads import registry as r_workloads

from repro_torch import obs as t_obs
from repro_torch.core import sim as t_sim
from repro_torch.obs import profile as t_profile
from repro_torch.obs.export import to_chrome_trace, write_chrome_trace
from repro_torch.obs.trace import TraceEvent, reconstruct_traces, schedule_events
from repro_torch.roofline import analysis as t_analysis
from repro_torch.scenarios import registry as t_scenarios
from repro_torch.scenarios.engine import CampaignEngine as TEngine
from repro_torch.workloads import registry as t_workloads
from repro_torch.workloads import resolve as t_resolve_workload

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# window billing, proactive multi-agent and the Rules 1-3 switcher, as in
# the reference's tests/test_obs.py
TRACE_STRATEGIES = ("central_single", "core", "hybrid")
N_SEEDS = 2
REF_HW = t_analysis.HW(**dataclasses.asdict(r_analysis.V5E))

_MICRO = {}


def micro_pair(family: str):
    """One MicroCosts measured by the reference for the family's workload,
    for both sides (the genome workload's calibration is a wall clock)."""
    spec = r_scenarios.get(family)
    key = (spec.workload, spec.n_nodes)
    if key not in _MICRO:
        ref = r_workloads.get(spec.workload).micro("placentia", n_nodes=spec.n_nodes)
        _MICRO[key] = (ref, t_sim.MicroCosts(**dataclasses.asdict(ref)))
    return _MICRO[key]


def engine_trace(spec, strategy, seed, **kw):
    res = TEngine(spec, strategy, seed=seed, trace=True, device="cpu", **kw).run()
    return res, res.trace


# ------------------------------------------------- engine == fold traces ---
@pytest.mark.parametrize("family", t_scenarios.names())
def test_trace_parity_every_family(family):
    """Event for event, the engine's trace == the fold's reconstruction, on
    every family under 3 strategies."""
    spec = t_scenarios.get(family)
    micro = micro_pair(family)[1]
    for strat in TRACE_STRATEGIES:
        ftraces = reconstruct_traces(spec, strat, n_seeds=N_SEEDS, micro=micro, device="cpu")
        for s in range(N_SEEDS):
            _, etr = engine_trace(spec, strat, s, micro=micro)
            assert etr.source == "engine" and ftraces[s].source == "kernel"
            assert etr.comparable() == ftraces[s].comparable(), (family, strat, s)


def test_trace_parity_under_ml_detector():
    spec = t_scenarios.get("mc_stress")
    micro = micro_pair("mc_stress")[1]
    ftraces = reconstruct_traces(spec, "core", n_seeds=N_SEEDS, micro=micro, detector="ml",
                                 device="cpu")
    for s in range(N_SEEDS):
        _, etr = engine_trace(spec, "core", s, micro=micro, detector="ml")
        assert etr.comparable() == ftraces[s].comparable()


# ----------------------------------------------- port engine == reference ---
@pytest.mark.parametrize("family,strategy", [
    ("mc_stress", "central_single"), ("spare_exhaustion", "core"), ("partition_split", "core"),
    ("straggler_drift", "hybrid"), ("cascade_spare", "agent"), ("table1_periodic", "decentral"),
    ("llm_pretrain_storm", "core"), ("decode_fleet_churn", "central_single")])
def test_engine_trace_matches_reference_engine(family, strategy):
    r_micro, t_micro = micro_pair(family)
    spec_r, spec_t = r_scenarios.get(family), t_scenarios.get(family)
    wl = None
    if spec_t.workload in ("train_llm", "serve_decode"):  # price on the reference's record
        wl = t_workloads.get(spec_t.workload, hw=REF_HW)
    for seed in range(N_SEEDS):
        want = REngine(spec_r, strategy, micro=r_micro, seed=seed, trace=True).run().trace
        got = TEngine(spec_t, strategy, micro=t_micro, seed=seed, trace=True, workload=wl,
                      device="cpu").run().trace
        assert got.to_dict() == want.to_dict(), (family, strategy, seed)


def test_trace_event_vocabulary():
    spec = t_scenarios.get("mc_stress")
    _, tr = engine_trace(spec, "central_single", 0, micro=micro_pair("mc_stress")[1])
    counts = tr.counts()
    assert counts["failure"] >= counts["verdict"] + counts.get("stranded", 0)
    assert counts.get("migrate", 0) == counts["verdict"]
    assert counts.get("ckpt_write", 0) > 0
    keys = [ev.sort_key() for ev in tr.events]
    assert keys == sorted(keys)


def test_schedule_events_clip_and_unknown_kind():
    spec = t_scenarios.get("table1_periodic")
    full = schedule_events(spec, spec.period_s * 4, mode_window=True, flags_stragglers=False)
    cut = schedule_events(spec, spec.period_s * 1.5, mode_window=True, flags_stragglers=False)
    assert len(full) == 3 and len(cut) == 1
    with pytest.raises(ValueError, match="unknown trace event kind"):
        TraceEvent.make(0.0, "not_a_kind")


def test_trace_off_by_default_and_record_unchanged():
    spec = t_scenarios.get("flaky_node")
    micro = micro_pair("flaky_node")[1]
    plain = TEngine(spec, "core", micro=micro, device="cpu").run()
    assert plain.trace is None and "trace" not in plain.to_dict()
    traced = TEngine(spec, "core", micro=micro, trace=True, device="cpu").run()
    assert traced.to_dict() == plain.to_dict()


# -------------------------------------------------------------- export ---
def test_chrome_trace_roundtrip(tmp_path):
    spec = t_scenarios.get("mc_stress")
    _, tr = engine_trace(spec, "core", 0, micro=micro_pair("mc_stress")[1])
    path = write_chrome_trace(tr, os.path.join(tmp_path, "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert len(evs) >= len(tr.events)
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
    assert {"M", "X", "i", "C"} <= {e["ph"] for e in evs}
    assert {"failure", "migrate"} <= {e["name"] for e in evs if e["ph"] == "i"}
    threads = [e for e in evs if e["ph"] == "M" and e["name"] == "thread_name"]
    assert len(threads) == tr.n_hosts + 1
    assert doc["otherData"]["scenario"] == "mc_stress"


def test_chrome_trace_lost_campaign():
    spec = t_scenarios.get("spare_exhaustion")
    res, tr = engine_trace(spec, "core", 0, micro=micro_pair("spare_exhaustion")[1])
    assert not res.survived
    span = next(e for e in to_chrome_trace(tr)["traceEvents"]
                if e["ph"] == "X" and "campaign" in e["name"])
    assert span["name"] == "campaign (lost)"
    assert span["dur"] == pytest.approx(res.failed_at_s * 1e6)


# ------------------------------------------------------------- profiling ---
def test_timed_and_stopwatch():
    calls = []
    out = t_profile.timed(lambda: calls.append(1) or 41 + 1, n=3, warmup=2, name="probe")
    assert isinstance(out, t_profile.Timed) and out.result == 42
    assert len(calls) == 5 and len(out.times_s) == 3
    assert out.min_s <= out.mean_s <= out.total_s
    assert out.to_dict()["name"] == "probe"
    with t_profile.stopwatch() as sw:
        pass
    assert sw.s >= 0.0
    tree = {"a": torch.ones(3), "b": [np.zeros(2), 1]}
    assert t_profile.timed(lambda: tree, n=1, warmup=0).result is tree


def test_utils_timing_compat():
    from repro_torch.utils import timing

    assert timing.stopwatch is t_profile.stopwatch and timing.timed is t_profile.timed
    assert timing.now_s is t_profile.now_s and t_obs.timed is t_profile.timed
    t = timing.Timer()
    with t.section("a"):
        pass
    assert t.times["a"][0] >= 0.0 and t.total("a") == sum(t.times["a"]) == t.mean("a")


def test_profile_replay_on_the_cpu(tmp_path):
    spec = t_scenarios.get("flaky_node")
    rec = t_profile.profile_replay(spec, "core", n_seeds=4, micro=micro_pair("flaky_node")[1],
                                   n_exec=2, trace_dir=str(tmp_path), device="cpu")
    assert rec["backend"] == "cpu" and rec["memory"] is None and rec["n_seeds"] == 4
    assert rec["execute_s"] > 0 and rec["seeds_per_s"] > 0 and rec["build_s"] >= 0
    assert {"tape_compile_s", "n_slots", "tile_slots", "n_devices", "compile_over_execute",
            "trace_dir"} <= set(rec)
    with open(tmp_path / "replay_trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_measured_step_surface_mapping():
    """No kernel hot path: None. The LLM workloads time the attention
    kernels' plain versions on the CPU, and say so."""
    assert t_workloads.get("analytic").measured_step_surface() is None
    assert t_resolve_workload("genome_search", device="cpu").measured_step_surface() is None
    for name, kernel in (("serve_decode", "decode_attention"), ("train_llm", "flash_attention")):
        rec = t_workloads.get(name).measured_step_surface(
            n_shards=(1, 2), batch=4, seq_len=64, heads=2, head_dim=64, device="cpu")
        assert rec["workload"] == name and rec["kernel"] == kernel
        assert rec["impl"] == "plain" and rec["backend"] == "cpu" and rec["launches"] == 0
        assert rec["n_shards"] == [1, 2] and all(t > 0 for t in rec["step_time_s"])


def test_measured_step_surface_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_workloads.get("serve_decode").measured_step_surface()
    with pytest.raises(ValueError, match="unknown kernel"):
        t_profile.time_kernel("rmsnorm", device="cpu")


@pytest.mark.parametrize("kernel,tol", [("decode_attention", 3e-5), ("flash_attention", 2e-5)])
def test_surface_cases_match_the_reference_cases(kernel, tol):
    """The timed call builds the reference's inputs (numpy, seed 0) and its
    plain version agrees with the Pallas kernel in interpret mode within
    tests/test_kernels.py's tolerance."""
    shape = (2, 128, 2, 64)  # batch, seq_len, heads, head_dim
    ref_case = getattr(r_profile, "_decode_case" if kernel == "decode_attention"
                       else "_attention_case")
    want = np.asarray(ref_case(*shape, "pallas")())
    got = t_profile._KERNEL_CASES[kernel][0](*shape, torch.device("cpu"))()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
