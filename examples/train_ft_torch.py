"""End-to-end run on the PyTorch port: train a ~100M-param LM for a few
hundred steps under the full FT stack (hybrid proactive + async
incremental checkpointing), with failures injected from the paper's
failure model, and compare FT overhead across policies (a miniature,
*measured* Table 1).

The default runs a ~10M model for 60 steps; pass --full for the
~100M/300-step configuration (8 layers, d 768, head dim 64, float32,
8 x 256 tokens a step).

    PYTHONPATH=src python examples/train_ft_torch.py [--full] [--steps N] [--device cuda]

The port of ``examples/train_ft.py`` over ``repro_torch``: the same
arguments, failure model and check (one final state across the three
policies). ``--device`` is ``cuda`` unless ``--device cpu`` is given
(without a card it raises); on the card the train step runs the
hand-written rmsnorm and flash-attention kernels (their float32 routes),
forward and backward. Parameters come from a ``torch.Generator`` seeded 0,
batches from ``data.synthetic`` (numpy, seed 0), and each policy's
checkpoints go to a fresh temporary directory, removed after its run.
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.failure import FailureModel
from repro_torch.core.trainer import FTTrainer
from repro_torch.data.synthetic import token_batches
from repro_torch.models import build_model
from repro_torch.train.step import abstract_state, make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_count, tree_hash

POLICIES = [
    ("checkpoint_sync", dict(policy="checkpoint", async_ckpt=False)),
    ("hybrid_proactive", dict(policy="hybrid", async_ckpt=False)),
    ("hybrid+async_incr", dict(policy="hybrid", async_ckpt=True)),
]


def config(full: bool):
    """The reference example's two configurations of qwen2.5-3b's family."""
    base = get_arch("qwen2.5-3b")
    if full:
        return dataclasses.replace(
            base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab=32000, dtype="float32",
        ), 300, 8, 256
    return dataclasses.replace(
        base, n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab=8192, dtype="float32",
    ), 60, 4, 128


def failures(steps: int):
    """The reference example's failure model over ``steps`` one-second steps."""
    return FailureModel(
        kind="random", n_nodes=4, horizon_s=steps, period_s=max(steps / 2, 1),
        per_window=1, seed=4,
    ).events()


def main(argv=None):
    """Runs the example; returns {policy: (report, wall seconds, state hash)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, steps, batch, seq = config(args.full)
    steps = args.steps or steps
    model = build_model(cfg)
    train_step, init_state = make_train_step(model, lr=3e-4)
    make_batch = token_batches(seed=0, batch=batch, seq=seq, vocab=cfg.vocab)

    nparams = tree_count(abstract_state(model)["params"])
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"~{nparams/1e6:.1f}M params; {steps} steps of {batch}x{seq} tokens on {dev}")

    fails = failures(steps)
    print(f"injected failures: {[(round(e.t,1), 'predictable' if e.predictable else 'surprise') for e in fails]}")

    def mk_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return init_state(gen)

    results = {}
    for name, kw in POLICIES:
        with tempfile.TemporaryDirectory(prefix=f"train_ft_torch_{name.replace('+', '_')}_") as d:
            tr = FTTrainer(train_step, mk_state, make_batch, ckpt_dir=d,
                           ckpt_every=max(steps // 8, 1), seed=5, device=str(dev), **kw)
            t0 = time.perf_counter()
            rep = tr.run(steps, failures=list(fails))
            wall = time.perf_counter() - t0
            h = tree_hash(tr.state)
            del tr
        results[name] = (rep, wall, h)
        print(f"{name:18s} wall={wall:7.2f}s train={rep.train_time_s:7.2f}s "
              f"ft={rep.ft_time_s:6.2f}s reexec={rep.steps_reexecuted:3d} "
              f"migr={rep.migrations} restores={rep.restores} "
              f"overhead={100*rep.overhead_fraction:5.1f}%")

    hashes = {h for _, _, h in results.values()}
    print(f"\nall policies bit-identical final state: {len(hashes) == 1}")
    ck = results["checkpoint_sync"][0]
    hy = results["hybrid_proactive"][0]
    print(f"re-executed steps: checkpoint={ck.steps_reexecuted} vs hybrid={hy.steps_reexecuted} "
          f"(proactive migration avoids rollback for predicted failures)")
    assert len(hashes) == 1
    print("OK")
    return results


if __name__ == "__main__":
    main()
