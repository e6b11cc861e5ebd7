"""Training launcher: a registered architecture (reduced or full), any FT
policy, failure injection from the paper's models.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --steps 50 \
      --policy hybrid --failures random --per-hour 2 [--full] [--json] [--device cuda]

The port of ``repro/launch/train.py``: the same flags (``--policy none``
trains without fault tolerance, where the reference's launcher maps it to
``checkpoint``), plus ``--device``
(``cuda`` unless ``--device cpu`` is given; without a CUDA device and
without that flag it raises) and ``--repeat-batch`` (every step trains on
step 0's batch: a run whose loss must fall). The default is the reduced
config; ``--full`` is the exact assigned config (gemma-2b at full width
needs the card: ~30 GB of float32 masters and AdamW moments). Activations
run in the config's dtype, the parameters and optimizer state in float32.

Supervision contract: ``--json`` makes the final line a single JSON object
with the run's counters, step times, tokens/s, peak device memory and
losses; the exit code is typed per ``repro_torch.orchestrator.contract``
(0 ok).
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import all_archs, get_arch
from repro_torch.core.failure import FailureEvent, FailureModel
from repro_torch.core.trainer import FTReport, FTTrainer
from repro_torch.data.synthetic import token_batches
from repro_torch.models import build_model
from repro_torch.orchestrator.contract import EXIT_OK
from repro_torch.train.step import make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes

POLICIES = ["none", "checkpoint", "agent", "core", "hybrid"]


def failure_schedule(kind: str, steps: int, hosts: int, per_hour: int) -> List[FailureEvent]:
    """The reference launcher's schedule: ``steps`` one-second steps."""
    if kind == "none":
        return []
    return FailureModel(
        kind=kind, n_nodes=hosts, horizon_s=float(steps),
        period_s=max(steps / max(per_hour, 1), 1.0), offset_s=steps * 0.25, seed=11,
    ).events()


def make_trainer(cfg, *, lr: float = 3e-4, batch: int = 4, seq: int = 128,
                 policy: str = "hybrid", hosts: int = 4, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 10, async_ckpt: bool = False, device: str = "cuda",
                 repeat_batch: bool = False, trainer_seed: int = 11,
                 speculative: bool = False):
    """FTTrainer (seeded ``trainer_seed``) over ``cfg``'s train step with
    batches from ``data.synthetic`` (seed 0), parameters from a torch
    Generator seeded 0 on ``device``. Returns (trainer, losses): ``losses``
    gathers each executed step's loss (a tensor) as the run goes."""
    dev = resolve_device(device)
    model = build_model(cfg)
    train_step, init_state = make_train_step(model, lr=lr)
    stream = token_batches(seed=0, batch=batch, seq=seq, vocab=cfg.vocab)
    make_batch = (lambda step: stream(0)) if repeat_batch else stream
    losses: List[torch.Tensor] = []

    def step(state, b):
        state, metrics = train_step(state, b)
        losses.append(metrics["loss"])
        return state, metrics

    def fresh_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return init_state(gen)

    trainer = FTTrainer(
        step, fresh_state, make_batch,
        policy=policy,
        n_hosts=hosts, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, async_ckpt=async_ckpt,
        seed=trainer_seed, device=str(dev), speculative=speculative,
    )
    return trainer, losses


def summary(arch: str, policy: str, rep: FTReport, losses, batch: int, seq: int,
            peak_bytes: Optional[int]) -> dict:
    """The ``--json`` status object."""
    step_s = statistics.median(rep.step_s) if rep.step_s else 0.0
    return {
        "status": "ok",
        "exit_code": EXIT_OK,
        "arch": arch,
        "policy": policy,
        "steps": rep.steps_run,
        "steps_reexecuted": rep.steps_reexecuted,
        "migrations": rep.migrations,
        "restores": rep.restores,
        "checkpoints": rep.checkpoints,
        "train_time_s": round(rep.train_time_s, 4),
        "ft_time_s": round(rep.ft_time_s, 4),
        "overhead_fraction": round(rep.overhead_fraction, 6),
        "step_s_median": step_s,
        "tokens_per_s": batch * seq / step_s if step_s else 0.0,
        "peak_device_bytes": peak_bytes,
        "losses": [float(x) for x in losses],
    }


def main(argv=None) -> int:
    res = run(argv)
    return res["exit_code"]


def run(argv=None) -> dict:
    """Parse the flags, train, print; returns the ``--json`` status object."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(all_archs()))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="hybrid", choices=POLICIES)
    ap.add_argument("--failures", default="none", choices=["none", "periodic", "random"])
    ap.add_argument("--per-hour", type=int, default=1, dest="per_hour")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, emptied first (default: a temporary one)")
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--full", action="store_true", help="full assigned config")
    ap.add_argument("--repeat-batch", action="store_true", dest="repeat_batch",
                    help="train every step on step 0's batch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="final line is one machine-readable JSON status object")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    failures = failure_schedule(args.failures, args.steps, args.hosts, args.per_hour)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_ckpt_")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        trainer, losses = make_trainer(
            cfg, lr=args.lr, batch=args.batch, seq=args.seq, policy=args.policy,
            hosts=args.hosts, ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
            async_ckpt=args.async_ckpt, device=args.device, repeat_batch=args.repeat_batch)
        print(f"{args.arch}{'' if args.full else ' (reduced)'}: "
              f"{tree_bytes(trainer.state['params']) / 4e6:.1f}M params, policy={args.policy}, "
              f"device={dev}")
        if failures:
            print(f"injected failures at steps: {[round(e.t, 1) for e in failures]}")
        rep = trainer.run(args.steps, failures=failures)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    res = summary(args.arch, args.policy, rep, losses, args.batch, args.seq, peak)
    if args.as_json:
        print(json.dumps(res))
    else:
        print(f"steps={rep.steps_run} reexec={rep.steps_reexecuted} "
              f"migrations={rep.migrations} restores={rep.restores} "
              f"checkpoints={rep.checkpoints}")
        print(f"train={rep.train_time_s:.2f}s ft={rep.ft_time_s:.3f}s "
              f"overhead={100 * rep.overhead_fraction:.1f}% step={res['step_s_median']:.4f}s "
              f"tokens/s={res['tokens_per_s']:.1f} loss {res['losses'][0]:.4f} -> "
              f"{res['losses'][-1]:.4f}")
    return res


if __name__ == "__main__":
    raise SystemExit(main())
