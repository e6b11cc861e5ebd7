"""The port's fault-tolerant trainer (``core.trainer.FTTrainer``) on its real
training loop, on the CPU (float32): the lossless invariant under the
four policies, bit for bit, and the FTReport counters against the
reference's FTTrainer on the same model (gemma-2b reduced), batches and
schedule; Fig 15's four states against the reference's on its model
(qwen2.5-3b reduced); the speculative trainer; elastic re-planning; the
launchers.

The reference's trainer runs once per file, in the module-scoped
``ref_runs`` fixture (its own trainer tests are ``slow``)."""
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import elastic as jax_elastic
from repro.core.failure import FailureEvent as JaxFailureEvent
from repro.core.trainer import FTTrainer as JaxFTTrainer
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.core import elastic
from repro_torch.core.failure import FailureEvent
from repro_torch.data.synthetic import token_batches
from repro_torch.launch import fig15, train
from repro_torch.launch.train import make_trainer
from repro_torch.utils.tree import tree_hash

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# tests/test_trainer_integration.py's schedule
STEPS, CKPT_EVERY, SEED = 16, 4, 2
FAILS = ((5.0, True), (11.0, False))
COUNTERS = ("steps_run", "steps_reexecuted", "migrations", "false_migrations", "restores",
            "checkpoints", "rebalances", "elastic_shrinks")


def _cfg():
    return get_arch("gemma-2b").reduced()


def _port_run(policy, failures, tmp_path, steps=STEPS, **kw):
    tr, _ = make_trainer(_cfg(), lr=1e-4, batch=2, seq=32, policy=policy, ckpt_every=CKPT_EVERY,
                         trainer_seed=SEED, device="cpu", ckpt_dir=str(tmp_path / policy), **kw)
    rep = tr.run(steps, failures=failures, step_time_s=1.0)
    return tree_hash(tr.state), rep


def _fails(cls=FailureEvent):
    return [cls(t=t, node=0, predictable=p) for t, p in FAILS]


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's FTTrainer fed the port's numpy batches: the hybrid
    and checkpoint runs of the schedule on gemma-2b reduced, and Fig 15's
    four states on qwen2.5-3b reduced (bench_fig15.py's model and
    arguments)."""
    root = tmp_path_factory.mktemp("ref_ft")
    cfg = jax_get_arch("gemma-2b").reduced()
    ts, init_state, *_ = jax_make_train_step(jax_build_model(cfg))

    def run(policy, failures, steps, batch, seq, ckpt_every, seed, name, **kw):
        d = str(root / name)
        shutil.rmtree(d, ignore_errors=True)
        tr = JaxFTTrainer(ts, lambda: init_state(jax.random.key(0)),
                          token_batches(0, batch, seq, cfg.vocab), policy=policy, ckpt_dir=d,
                          ckpt_every=ckpt_every, seed=seed, **kw)
        rep = tr.run(steps, failures=failures, step_time_s=1.0)
        return tr, rep

    out = {}
    for policy in ("hybrid", "checkpoint"):
        out[policy] = run(policy, _fails(JaxFailureEvent), STEPS, 2, 32, CKPT_EVERY, SEED,
                          policy)[1]
    states = {"a_ideal": ([], False),
              "b_unpredicted_failure": ([JaxFailureEvent(t=10.0, node=0, predictable=False)],
                                        False),
              "c_false_prediction": ([], True),
              "d_ideal_prediction": ([JaxFailureEvent(t=10.0, node=0, predictable=True)], False)}
    qcfg = jax_get_arch(fig15.FIG15_ARCH).reduced()
    qts, q_init_state, *_ = jax_make_train_step(jax_build_model(qcfg))
    rows, h_ref = [], None
    for name, (failures, forced) in states.items():
        d = str(root / name)
        tr = JaxFTTrainer(qts, lambda: q_init_state(jax.random.key(0)),
                          token_batches(0, 2, 32, qcfg.vocab), policy="hybrid", ckpt_dir=d,
                          ckpt_every=6, seed=8)
        if forced:
            tr.rng = fig15.ForcedFalseAlarm()
        rep = tr.run(24, failures=failures)
        from repro.utils.tree import tree_hash as jax_tree_hash

        h = jax_tree_hash(jax.tree.map(np.asarray, tr.state))
        h_ref = h_ref or h
        rows.append(dict(state=name, migrations=rep.migrations, restores=rep.restores,
                         reexecuted=rep.steps_reexecuted, lossless=h == h_ref))
    out["fig15"] = rows
    return out


@pytest.mark.parametrize("policy", ["hybrid", "agent", "core", "checkpoint"])
def test_policies_lossless_under_failures(policy, tmp_path):
    ref_hash, _ = _port_run(policy + "_ref", [], tmp_path)
    h, rep = _port_run(policy, _fails(), tmp_path)
    assert h == ref_hash, (policy, rep)
    if policy == "checkpoint":
        assert rep.restores == 2
    else:
        assert rep.migrations >= 1
        assert rep.steps_reexecuted <= 4  # only the unpredicted one rolls back


@pytest.mark.parametrize("policy", ["hybrid", "checkpoint"])
def test_report_counters_match_reference(policy, ref_runs, tmp_path):
    _, rep = _port_run(policy, _fails(), tmp_path)
    want = ref_runs[policy]
    assert {k: getattr(rep, k) for k in COUNTERS} == {k: getattr(want, k) for k in COUNTERS}
    kinds = [e.get("kind") for e in rep.events if "kind" in e]
    assert kinds == [e.get("kind") for e in want.events if "kind" in e]
    assert len(rep.step_s) == rep.steps_run and rep.train_time_s > 0


def test_fig15_states_match_reference(ref_runs):
    """Fig 15's four states on the reference's model, qwen2.5-3b reduced."""
    assert fig15.FIG15_ARCH == "qwen2.5-3b" and get_arch(fig15.FIG15_ARCH).qkv_bias
    rows, checks = fig15.fig15_states(device="cpu")
    assert rows == ref_runs["fig15"]
    assert all(checks.values()), checks


def test_ft_policy_table_lossless_and_proactive():
    rows, checks = fig15.ft_policy_table(device="cpu")
    assert [r["policy"] for r in rows] == [name for name, _ in fig15.POLICY_TABLE]
    assert checks["lossless_all_policies"] and checks["proactive_reexecutes_less"]
    assert rows[0]["migrations"] == 1 and rows[1]["migrations"] == 0
    assert rows[1]["restores"] == 2 and rows[0]["restores"] == rows[2]["restores"] == 1


def test_speculative_trainer_lossless(tmp_path):
    """Speculative pre-staging: lossless, and the migration happened from the
    staged copy (only the delta crossed at migrate time)."""
    ref_hash, _ = _port_run("hybrid_ref", [], tmp_path)
    h, rep = _port_run("hybrid", [FailureEvent(t=9.0, node=0, predictable=True)], tmp_path,
                       speculative=True)
    assert h == ref_hash
    stages = [e for e in rep.events if e.get("kind") == "speculative_stage"]
    assert stages, "warning band should have pre-staged"
    assert rep.migrations == 1 and rep.steps_reexecuted == 0


@pytest.mark.parametrize("n_shards,alive,old", [
    (8, [0, 1, 2, 3], None),
    (8, [0, 2, 3], {0: [0, 4], 1: [1, 5], 2: [2, 6], 3: [3, 7]}),
    (5, [4, 1], {1: [0, 1], 3: [2, 3, 4]}),
])
def test_replan_matches_reference(n_shards, alive, old):
    got = elastic.replan(n_shards, alive, elastic.Plan(old, []) if old else None)
    want = jax_elastic.replan(n_shards, alive, jax_elastic.Plan(old, []) if old else None)
    assert (got.assignment, got.moved) == (want.assignment, want.moved)


@pytest.mark.parametrize("global_batch,n_alive", [(4, 3), (16, 5), (7, 7), (3, 4)])
def test_reshard_batch_matches_reference(global_batch, n_alive):
    assert elastic.reshard_batch(global_batch, n_alive) == \
        jax_elastic.reshard_batch(global_batch, n_alive)


def test_launch_train_json_contract(capsys):
    rc = train.main(["--device", "cpu", "--steps", "4", "--failures", "periodic",
                     "--per-hour", "2", "--ckpt-every", "2", "--json"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["status"] == "ok" and res["exit_code"] == 0 and res["steps"] >= 4
    assert res["restores"] + res["migrations"] >= 1
    assert len(res["losses"]) == res["steps"] and res["peak_device_bytes"] is None
    assert res["tokens_per_s"] > 0


def test_launch_train_loss_falls_on_a_repeated_batch(capsys):
    res = train.run(["--device", "cpu", "--steps", "5", "--policy", "none", "--repeat-batch",
                     "--lr", "3e-3"])
    assert res["checkpoints"] == 0 and res["migrations"] == 0
    assert res["losses"][-1] < res["losses"][0]


def test_launch_train_without_cuda_and_without_device_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        fig15.main([])
