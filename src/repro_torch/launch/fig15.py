"""The paper's Fig 15 and the FT policy table, on the port's real training
loop.

  PYTHONPATH=src python -m repro_torch.launch.fig15 [--json] [--out DIR] [--device cuda]

The counterpart of ``benchmarks/bench_fig15.py`` and
``benchmarks/bench_ft_trainer.py``, on their models: Fig 15 trains
qwen2.5-3b reduced (qkv bias included), the policy table gemma-2b reduced:

* Fig 15's four prediction/failure states between two checkpoints, each
  accounted on its own run of the hybrid policy (24 steps, a checkpoint
  every 6): (a) ideal — no prediction, no failure; (b) an unpredicted
  failure — reactive restore, steps lost; (c) a false prediction — an
  unnecessary migration, nothing lost; (d) a predicted failure — a
  proactive migration, nothing lost. Every state must end bit-identical to
  (a).
* The three-policy table: hybrid with a synchronous checkpoint backstop,
  checkpoint only, and hybrid with asynchronous incremental checkpoints,
  under one predicted (t = 8) and one unpredicted (t = 20) failure, 30
  steps, a checkpoint every 5: the overhead fraction of each, and the
  lossless check across the three.

Writes ``fig15_states.csv`` and ``ft_trainer.csv`` to ``--out`` (default
``$BENCH_OUT``, else ``bench_out_torch/``). Runs on the card unless
``--device cpu``. Exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.failure import FailureEvent
from repro_torch.launch.tables import write_csv
from repro_torch.launch.train import make_trainer
from repro_torch.utils.tree import tree_hash

FIG15_ARCH = "qwen2.5-3b"  # bench_fig15.py's model
TABLE_ARCH = "gemma-2b"  # bench_ft_trainer.py's model
LR = 1e-4  # the reference benches' make_train_step default


class ForcedFalseAlarm:
    """The false-alarm draw of Fig 15(c): exactly one alarm, at the 10th
    probe (``bench_fig15.py``'s ``_ForcedRng``)."""

    def __init__(self):
        self.calls = 0

    def random(self):
        self.calls += 1
        return 0.0 if self.calls == 10 else 1.0


def _run(trainer, steps, failures, **kw):
    try:
        return trainer.run(steps, failures=failures, **kw)
    finally:
        shutil.rmtree(trainer.store.root, ignore_errors=True)


def fig15_states(device: str = "cuda", steps: int = 24):
    """Fig 15's four states: (rows, checks)."""
    cfg = get_arch(FIG15_ARCH).reduced()

    def scenario(failures, force_false_alarm=False):
        tr, _ = make_trainer(cfg, lr=LR, batch=2, seq=32, policy="hybrid", ckpt_every=6,
                             trainer_seed=8, device=device)
        if force_false_alarm:
            tr.rng = ForcedFalseAlarm()
        rep = _run(tr, steps, failures)
        return tree_hash(tr.state), rep

    h_ref, rep_a = scenario([])
    runs = [("a_ideal", h_ref, rep_a),
            ("b_unpredicted_failure",
             *scenario([FailureEvent(t=10.0, node=0, predictable=False)])),
            ("c_false_prediction", *scenario([], force_false_alarm=True)),
            ("d_ideal_prediction",
             *scenario([FailureEvent(t=10.0, node=0, predictable=True)]))]
    rows = [dict(state=name, migrations=rep.migrations, restores=rep.restores,
                 reexecuted=rep.steps_reexecuted, lossless=h == h_ref)
            for name, h, rep in runs]
    checks = {
        "all_states_lossless": all(r["lossless"] for r in rows),
        "b_rolls_back": rows[1]["restores"] == 1 and rows[1]["reexecuted"] > 0,
        "c_migrates_without_loss": rows[2]["migrations"] >= 1 and rows[2]["reexecuted"] == 0,
        "d_avoids_rollback": rows[3]["migrations"] >= 1 and rows[3]["reexecuted"] == 0,
    }
    return rows, checks


POLICY_TABLE = (("hybrid+sync_ckpt", dict(policy="hybrid", async_ckpt=False)),
                ("checkpoint_only", dict(policy="checkpoint", async_ckpt=False)),
                ("hybrid+async_incr", dict(policy="hybrid", async_ckpt=True)))
POLICY_FAILURES = (FailureEvent(t=8.0, node=0, predictable=True),
                   FailureEvent(t=20.0, node=0, predictable=False))


def ft_policy_table(device: str = "cuda", steps: int = 30):
    """The three policies under one predicted and one unpredicted failure:
    (rows, checks)."""
    cfg = get_arch(TABLE_ARCH).reduced()
    rows, hashes = [], {}
    for name, kw in POLICY_TABLE:
        tr, _ = make_trainer(cfg, lr=LR, batch=2, seq=64, ckpt_every=5, trainer_seed=3,
                             device=device, **kw)
        rep = _run(tr, steps, list(POLICY_FAILURES), step_time_s=1.0)
        hashes[name] = tree_hash(tr.state)
        rows.append(dict(policy=name, steps=rep.steps_run, reexecuted=rep.steps_reexecuted,
                         migrations=rep.migrations, restores=rep.restores,
                         checkpoints=rep.checkpoints, train_s=round(rep.train_time_s, 3),
                         ft_s=round(rep.ft_time_s, 4),
                         overhead_pct=round(100 * rep.overhead_fraction, 2)))
    checks = {
        "lossless_all_policies": len(set(hashes.values())) == 1,
        "proactive_reexecutes_less": rows[0]["reexecuted"] <= rows[1]["reexecuted"],
        "async_ckpt_cheaper": rows[2]["ft_s"] <= rows[0]["ft_s"] * 1.5,
    }
    return rows, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="output directory (default $BENCH_OUT or "
                    "bench_out_torch/)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    out_dir = args.out or os.environ.get("BENCH_OUT", "bench_out_torch")
    states, state_checks = fig15_states(args.device)
    table, table_checks = ft_policy_table(args.device)
    paths = [write_csv(out_dir, "fig15_states.csv", states),
             write_csv(out_dir, "ft_trainer.csv", table)]
    checks = {**state_checks, **table_checks}
    for r in states:
        print(f"  {r['state']:24s} migr={r['migrations']} restores={r['restores']} "
              f"reexec={r['reexecuted']} lossless={r['lossless']}")
    for r in table:
        print(f"  {r['policy']:20s} overhead={r['overhead_pct']}% reexec={r['reexecuted']} "
              f"ft_s={r['ft_s']} train_s={r['train_s']}")
    for k, v in checks.items():
        print(f"  {k}: {'PASS' if v else 'FAIL'}")
    print("\n".join(paths))
    if args.as_json:
        print(json.dumps({"fig15_states": states, "ft_trainer": table, "checks": checks},
                         default=lambda o: o.item() if isinstance(o, np.generic) else str(o)))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
