"""Quickstart on the PyTorch port: train a small LM with multi-agent fault
tolerance enabled, inject a predicted and an unpredicted failure, and
verify the run is bit-identical to a failure-free run.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 40] [--device cuda]

The port of ``examples/quickstart.py`` over ``repro_torch``: the same
arguments and checks. ``--device`` is ``cuda`` unless ``--device cpu`` is
given (without a card it raises); on the card the train step runs the
hand-written rmsnorm and flash-attention kernels, forward and backward.
The parameters come from a ``torch.Generator`` seeded 0 and the batches
from ``data.synthetic`` (numpy, seed 0); the checkpoints go to a fresh
temporary directory of the example's own, removed at the end.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.core.failure import FailureEvent
from repro_torch.core.trainer import FTTrainer
from repro_torch.data.synthetic import token_batches
from repro_torch.models import build_model
from repro_torch.train.step import make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_hash


def main(argv=None):
    """Runs the example; returns the two runs' reports and state hashes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    train_step, init_state = make_train_step(model, lr=1e-3)
    make_batch = token_batches(seed=0, batch=4, seq=64, vocab=cfg.vocab)

    def mk_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return init_state(gen)

    with tempfile.TemporaryDirectory(prefix="quickstart_torch_") as tmp:
        print(f"== failure-free reference run ({args.arch} reduced, {dev}) ==")
        ref = FTTrainer(train_step, mk_state, make_batch, policy="hybrid",
                        ckpt_dir=os.path.join(tmp, "ref"), ckpt_every=8, seed=1,
                        device=str(dev))
        rep0 = ref.run(args.steps, failures=[])
        h0 = tree_hash(ref.state)
        print(f"   steps={rep0.steps_run} train_time={rep0.train_time_s:.2f}s")

        print("== run with failures (1 predicted, 1 unpredicted) ==")
        tr = FTTrainer(train_step, mk_state, make_batch, policy="hybrid",
                       ckpt_dir=os.path.join(tmp, "ft"), ckpt_every=8, seed=1,
                       device=str(dev))
        fails = [
            FailureEvent(t=args.steps * 0.3, node=0, predictable=True),
            FailureEvent(t=args.steps * 0.7, node=0, predictable=False),
        ]
        rep = tr.run(args.steps, failures=fails)
        h1 = tree_hash(tr.state)
    print(f"   proactive migrations: {rep.migrations} (predicted failure avoided)")
    print(f"   checkpoint restores:  {rep.restores} (unpredicted failure)")
    print(f"   steps re-executed:    {rep.steps_reexecuted}")
    print(f"   FT overhead:          {100*rep.overhead_fraction:.1f}% of train time")
    print(f"   final state identical to failure-free run: {h0 == h1}")
    assert h0 == h1, "FT must be lossless"
    print("OK")
    return {"reference": rep0, "ft": rep, "hashes": (h0, h1)}


if __name__ == "__main__":
    main()
