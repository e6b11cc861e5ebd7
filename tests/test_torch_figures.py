"""The paper's Figures 8-13 on the port against the reference benches:
``reinstate_trials`` and the three sweeps of ``benchmarks/bench_{dependencies,
datasize, process_size}.py`` with their 10 paper-claim checks.

Reinstate time is a measured part (wall clock) plus a modelled part. With
the clock held still both packages measure 0 s, so what is left is the
modelled part and the staging overhead: those must be bitwise equal, and
so must the CSVs. With the real clock the sweeps must still pass every
check and write the reference's columns."""
import csv
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before anything that imports repro.telemetry)

from repro_torch.core.cluster import get_profile
from repro_torch.core.migration import move_state
from repro_torch.launch import figures as t_figures

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))  # the reference benches import as `benchmarks.*`

TRIALS = 3
SWEEPS = {"dependencies": "bench_dependencies", "datasize": "bench_datasize",
          "process_size": "bench_process_size"}


@pytest.fixture
def still_clock(monkeypatch):
    """``time.perf_counter`` held at one instant: every measured term of
    both packages reads 0 s."""
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.0)


@pytest.fixture
def ref_bench(monkeypatch, tmp_path):
    """The reference's ``benchmarks.common``, writing into ``tmp_path/ref``."""
    common = importlib.import_module("benchmarks.common")
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path / "ref"))
    return common


@pytest.mark.parametrize("mechanism", ["agent", "core", "agent_batched"])
def test_reinstate_trials_modelled_terms_bitwise(mechanism, still_clock, ref_bench):
    for profile, z, s_d, s_p in (("placentia", 3, 2 ** 34, 2 ** 34),
                                 ("acet", 63, 2 ** 29, 2 ** 31),
                                 ("glooscap", 10, 2 ** 41, 2 ** 23)):
        want = ref_bench.reinstate_trials(mechanism, profile, z, s_d, s_p, TRIALS)
        got = t_figures.reinstate_trials(mechanism, profile, z, s_d, s_p, TRIALS, device="cpu")
        assert got == want, (mechanism, profile, z)


@pytest.mark.parametrize("mechanism", ["agent", "core", "agent_batched"])
def test_reinstate_trials_staging_bitwise_on_the_real_clock(mechanism, ref_bench):
    """Staging is all modelled; reinstate's measured part is dependency
    surgery of microseconds, so the means agree far inside a millisecond."""
    want = ref_bench.reinstate_trials(mechanism, "brasdor", 10, 2 ** 30, 2 ** 30, TRIALS)
    got = t_figures.reinstate_trials(mechanism, "brasdor", 10, 2 ** 30, 2 ** 30, TRIALS,
                                     device="cpu")
    assert got[2] == want[2]
    assert abs(got[0] - want[0]) < 1e-3


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_csv_byte_identical_to_reference_bench(sweep, still_clock, ref_bench, tmp_path):
    bench = importlib.import_module(f"benchmarks.{SWEEPS[sweep]}")
    rpath, rrows, rchecks = bench.run(trials=TRIALS)
    tpath, trows, tchecks = getattr(t_figures, sweep)(str(tmp_path / "port"), TRIALS, "cpu")
    assert Path(tpath).name == Path(rpath).name
    assert Path(tpath).read_bytes() == Path(rpath).read_bytes()
    assert trows == rrows and tchecks == rchecks and all(tchecks.values())


def test_sweeps_on_the_real_clock_pass_the_ten_checks(tmp_path):
    res = t_figures.run(str(tmp_path), trials=TRIALS, device="cpu")
    assert len(res["checks"]) == 10 and all(res["checks"].values()), res["checks"]
    assert [Path(p).name for p in res["paths"]] == ["fig8_9_dependencies.csv",
                                                    "fig10_11_datasize.csv",
                                                    "fig12_13_process_size.csv"]
    columns = [["mechanism", "cluster", "Z", "reinstate_mean_s", "reinstate_std_s"],
               ["mechanism", "cluster", "n", "s_d_bytes", "reinstate_mean_s", "reinstate_std_s",
                "staging_overhead_s"],
               ["mechanism", "cluster", "n", "s_p_bytes", "reinstate_mean_s", "reinstate_std_s"]]
    for path, cols, n_rows in zip(res["paths"], columns, (120, 64, 72)):
        with open(path) as f:
            rows = list(csv.reader(f))
        assert rows[0] == cols and len(rows) == 1 + n_rows


def test_figures_launcher_on_the_cpu(tmp_path, capsys):
    rc = t_figures.main(["--device", "cpu", "--trials", str(TRIALS), "--out", str(tmp_path),
                         "--json"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count(": PASS") == 10 and "FAIL" not in out
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert res["ok"] and res["device"] == "cpu" and res["trials"] == TRIALS
    assert sorted(res["seconds"]) == ["datasize", "dependencies", "process_size"]


def test_figures_launcher_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_figures.main(["--out", str(tmp_path), "--trials", "1"])


def test_tensor_payload_migrates_hash_verified():
    """A tensor payload round-trips with its hash checked, and prices its
    metadata term from its own pickled length, not the array's."""
    prof = get_profile("placentia")
    arr = {"partial": np.zeros(1 << 14, np.float32), "cursor": 3}
    ten = {"partial": torch.zeros(1 << 14, dtype=torch.float32), "cursor": 3}
    moved, rep = move_state(ten, prof)
    assert rep.hash_ok and torch.equal(moved["partial"], ten["partial"])
    assert isinstance(moved["partial"], torch.Tensor) and moved["cursor"] == 3
    _, rep_arr = move_state(arr, prof)
    assert rep.bytes_moved != rep_arr.bytes_moved
