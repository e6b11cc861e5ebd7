#!/usr/bin/env python3
"""Peak device memory of full-width training steps at several depths (and
expert counts).

  PYTHONPATH=src python tools/train_peak.py --arch deepseek-7b --layers 12 14 16
  PYTHONPATH=src python tools/train_peak.py --arch kimi-k2-1t-a32b --layers 1 \
      --experts 128 160 192 --grad-check

For each depth (and, with ``--experts``, each expert count at each depth):
the registered config with ``n_layers`` (and ``n_experts``) cut to it,
trained through ``repro_torch.launch.train.make_trainer`` as
``chip_smoke.py``'s train phase trains it (its activations, masters and
optimizer: bf16 activations, float32 masters and AdamW moments for most,
kimi-k2's bf16 masters and Adafactor; its TRAIN_BATCH x TRAIN_SEQ, one
repeated batch, no fault tolerance): the parameter count,
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` after STEPS
steps (the optimizer state exists from the first), or "out of memory".
With ``--grad-check`` also the peak of ``chip_smoke.train_grad_check`` on
the same config, which holds two gradient sets at once. The last line is
one JSON object with every reading, the card's name and its memory. Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import TRAIN_BATCH, TRAIN_SEQ, train_grad_check  # noqa: E402

STEPS = 2


def peak(fn) -> dict:
    """Runs ``fn`` on a freed card: its peak allocated and reserved bytes,
    or out of memory."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = dict(leftover_bytes=torch.cuda.memory_allocated())
    try:
        fn()
        torch.cuda.synchronize()
        row.update(peak_bytes=torch.cuda.max_memory_allocated(),
                   reserved_peak_bytes=torch.cuda.max_memory_reserved())
    except torch.cuda.OutOfMemoryError:
        row.update(peak_bytes=None, out_of_memory=True)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_trainer
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_count

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="+", required=True)
    ap.add_argument("--experts", type=int, nargs="+", default=[None])
    ap.add_argument("--grad-check", action="store_true", dest="grad_check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_peak: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    out = []
    for layers in args.layers:
        for experts in args.experts:
            changes = {"n_layers": layers}
            if experts is not None:
                changes["n_experts"] = experts
            cfg = dataclasses.replace(get_arch(args.arch), **changes)

            def train():
                tr, _ = make_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, policy="none",
                                     repeat_batch=True, device="cuda")
                try:
                    tr.run(STEPS, failures=[])
                finally:
                    shutil.rmtree(tr.store.root, ignore_errors=True)

            row = dict(layers=layers, experts=cfg.n_experts,
                       params=tree_count(build_model(cfg).init(None, "meta",
                                                               param_dtype=torch.float32)),
                       train=peak(train))
            if args.grad_check:
                row["grad_check"] = peak(lambda: train_grad_check(torch.device("cuda", 0), cfg))
            what = f"{args.arch} at {layers} layers" + (
                f", {experts} experts" if experts is not None else "")
            for key in ("train", "grad_check"):
                if key in row:
                    r = row[key]
                    print(f"{what}: {row['params'] / 1e9:.3f} B parameters, {key}: " + (
                        "out of memory" if r["peak_bytes"] is None else
                        f"peak max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB, "
                        f"max_memory_reserved {r['reserved_peak_bytes'] / 2**30:.2f} GiB of "
                        f"{total / 2**30:.2f}"))
            out.append(row)
    print(json.dumps({"arch": args.arch, "card": card, "total_bytes": total, "steps": STEPS,
                      "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
