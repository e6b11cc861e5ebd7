"""The paper's Tables 1-2 and its prediction statistics, priced by the port.

  PYTHONPATH=src python -m repro_torch.launch.tables [--json] [--out DIR] [--device cuda]

The counterpart of ``benchmarks/bench_table1.py``, ``bench_table2.py`` and
``bench_prediction.py``: the same ``measure_micro`` arguments, the same
``strategy_rows`` calls, the same row dicts, paper references and checks.
Table 1 is the paper's strategies between two checkpoints one hour apart
(Placentia, S_d = 2^19 KB, Z = 4, periodic failure at minute 15); it
validates the headline claim: checkpointing adds ~90 % for one random
failure an hour, multi-agent ~10 %. Table 2 is the five-hour job at
checkpoint periodicity 1/2/4 h; it validates that multi-agent costs under
0.35x the checkpointing time with 5 random failures an hour. The failure
predictor is trained on ``--device`` (the card unless ``--device cpu``) and
held to the paper's ~29 % coverage and ~64 % precision.

Writes ``table1.csv``, ``table2.csv`` and ``prediction.csv`` to ``--out``
(default ``$BENCH_OUT``, else ``bench_out_torch/``). ``--json`` makes the
last line one JSON object with the rows and checks. Exits 1 when a check
fails.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Dict, List, Optional

from repro_torch.core.predictor import FailurePredictor
from repro_torch.core.sim import MicroCosts, fmt_hms, measure_micro, strategy_rows
from repro_torch.utils.device import resolve_device, synchronize

TABLE1_PAPER = {
    "central_single": ("01:37:13", "01:53:27", "05:27:15"),
    "central_multi": ("01:38:22", "01:54:36", "05:33:00"),
    "decentral": ("01:37:11", "01:53:25", "05:27:05"),
    "agent": ("01:06:17", "01:06:17", "01:32:27"),
    "core": ("01:05:08", "01:05:08", "01:25:42"),
    "hybrid": ("01:05:08", "01:05:08", "01:25:42"),
}

TABLE2_PAPER_1RANDOM = {
    ("central_single", 1.0): "09:27:15",
    ("central_single", 2.0): "07:58:38",
    ("central_single", 4.0): "07:37:07",
    ("decentral", 1.0): "09:27:05",
    ("agent", 1.0): "05:31:14",
    ("agent", 2.0): "05:20:34",
    ("agent", 4.0): "05:16:27",
    ("core", 1.0): "05:26:13",
    ("core", 2.0): "05:16:22",
    ("core", 4.0): "05:13:32",
}


def write_csv(out_dir: str, name: str, rows: List[Dict]) -> str:
    """``benchmarks/common.py::write_csv``, writing into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    if rows:
        fields = []
        for r in rows:
            for k in r:
                if k not in fields:
                    fields.append(k)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
    return path


def _hms_to_s(x: str) -> int:
    h, m, s = x.split(":")
    return int(h) * 3600 + int(m) * 60 + int(s)


def table1(out_dir: str, micro: MicroCosts):
    rows = strategy_rows(1.0, [1.0], micro=micro, periodic_offset_min=15.0)
    out = []
    checks = {}
    for r in rows:
        ours = (r.exec_1periodic_s, r.exec_1random_s, r.exec_5random_s)
        paper = TABLE1_PAPER.get(r.strategy)
        rec = dict(
            strategy=r.strategy,
            predict=fmt_hms(r.predict_s),
            reinstate_s=round(r.reinstate_random_s, 2),
            overhead=fmt_hms(r.overhead_random_s),
            exec_nofail=fmt_hms(r.exec_nofail_s),
            exec_1periodic=fmt_hms(ours[0]),
            exec_1random=fmt_hms(ours[1]),
            exec_5random=fmt_hms(ours[2]),
            overhead_pct_1random=round(100 * (ours[1] - 3600) / 3600, 1),
        )
        if paper:
            rec["paper_1random"] = paper[1]
            err = abs(ours[1] - _hms_to_s(paper[1])) / _hms_to_s(paper[1])
            rec["rel_err_1random_pct"] = round(100 * err, 2)
            checks[f"{r.strategy}_within_3pct_of_paper"] = err < 0.03
        out.append(rec)
    # headline claim
    ck = next(r for r in out if r["strategy"] == "central_single")
    ag = next(r for r in out if r["strategy"] == "core")
    checks["checkpointing_~90pct_overhead"] = 75 <= ck["overhead_pct_1random"] <= 100
    checks["multi_agent_~10pct_overhead"] = 5 <= ag["overhead_pct_1random"] <= 15
    path = write_csv(out_dir, "table1.csv", out)
    return path, out, checks


def table2(out_dir: str, micro: MicroCosts):
    rows = strategy_rows(5.0, [1.0, 2.0, 4.0], micro=micro)
    out, checks = [], {}
    for r in rows:
        rec = dict(
            strategy=r.strategy,
            periodicity_h=r.periodicity_h,
            reinstate_s=round(r.reinstate_random_s, 2),
            overhead=fmt_hms(r.overhead_random_s),
            exec_1periodic=fmt_hms(r.exec_1periodic_s),
            exec_1random=fmt_hms(r.exec_1random_s),
            exec_5random=fmt_hms(r.exec_5random_s),
        )
        paper = TABLE2_PAPER_1RANDOM.get((r.strategy, r.periodicity_h))
        if paper:
            err = abs(r.exec_1random_s - _hms_to_s(paper)) / _hms_to_s(paper)
            rec["paper_1random"] = paper
            rec["rel_err_pct"] = round(100 * err, 2)
            checks[f"{r.strategy}@{r.periodicity_h}h_within_5pct"] = err < 0.05
        out.append(rec)

    by = {(r["strategy"], r["periodicity_h"]): r for r in out}
    ck5 = _hms_to_s(by[("central_single", 1.0)]["exec_5random"])
    ag5 = _hms_to_s(by[("core", 1.0)]["exec_5random"])
    checks["multi_agent_quarter_of_checkpointing_5failures"] = ag5 < 0.35 * ck5
    path = write_csv(out_dir, "table2.csv", out)
    return path, out, checks


def prediction(out_dir: str, device="cuda"):
    """The predictor trained on ``device``, evaluated on fresh telemetry
    (``bench_prediction.py``'s seeds and checks). Also returns the predictor
    and its training time in ms (host clock around the synchronised run)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    pred = FailurePredictor.train(seed=0, device=dev)
    synchronize(dev)
    train_ms = 1e3 * (time.perf_counter() - t0)
    stats = pred.evaluate(seed=99, n=4000)
    rows = [
        dict(metric="coverage", ours=round(stats["coverage"], 3), paper=0.29),
        dict(metric="precision", ours=round(stats["precision"], 3), paper=0.64),
    ]
    checks = {
        "coverage_~29pct": abs(stats["coverage"] - 0.29) < 0.08,
        "precision_~64pct": abs(stats["precision"] - 0.64) < 0.10,
    }
    path = write_csv(out_dir, "prediction.csv", rows)
    return path, rows, checks, pred, train_ms


def run(out_dir: Optional[str] = None, device="cuda", micro: Optional[MicroCosts] = None) -> Dict:
    """All three; ``micro`` pins the tables' micro-costs (tests pass one),
    else both tables are priced from one (memoised) ``measure_micro``."""
    out_dir = out_dir or os.environ.get("BENCH_OUT", "bench_out_torch")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    micro = micro or measure_micro("placentia", n_nodes=4, z=4, s_d_bytes=(2 ** 19) * 1024)
    p1, rows1, checks1 = table1(out_dir, micro)
    p2, rows2, checks2 = table2(out_dir, micro)
    tables_s = time.perf_counter() - t0
    p3, rows3, checks3, pred, train_ms = prediction(out_dir, dev)
    return {
        "device": str(dev),
        "paths": [p1, p2, p3],
        "table1": rows1,
        "table2": rows2,
        "prediction": rows3,
        "checks": {**checks1, **checks2, **checks3},
        "tables_s": tables_s,
        "predictor_train_ms": train_ms,
        "predictor": pred,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="output directory (default $BENCH_OUT or "
                    "bench_out_torch/)")
    ap.add_argument("--device", default="cuda", help="where the predictor trains: cuda or cpu")
    ap.add_argument("--json", action="store_true", help="last line: one JSON object")
    args = ap.parse_args(argv)
    res = run(args.out, args.device)
    for path in res["paths"]:
        print(path)
    for r in res["table1"]:
        print(f"  table1 {r['strategy']:16s} 1rnd={r['exec_1random']} "
              f"(+{r['overhead_pct_1random']}%) paper={r.get('paper_1random', '-')}")
    for r in res["table2"]:
        print(f"  table2 {r['strategy']:16s} p={r['periodicity_h']}h 1rnd={r['exec_1random']} "
              f"paper={r.get('paper_1random', '-')} err={r.get('rel_err_pct', '-')}%")
    for r in res["prediction"]:
        print(f"  {r['metric']}: ours={r['ours']} paper={r['paper']}")
    for k, v in res["checks"].items():
        print(f"  {k}: {'PASS' if v else 'FAIL'}")
    print(f"tables {res['tables_s']:.3f} s on the host; predictor trained in "
          f"{res['predictor_train_ms']:.1f} ms on {res['device']}")
    ok = all(res["checks"].values())
    if args.json:
        print(json.dumps({k: res[k] for k in ("device", "table1", "table2", "prediction",
                                              "checks", "tables_s", "predictor_train_ms")}
                         | {"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
