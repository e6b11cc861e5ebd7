#!/usr/bin/env python3
"""Peak device memory of full-width training steps at several depths.

  PYTHONPATH=src python tools/train_peak.py --arch deepseek-7b --layers 12 14 16

For each depth: the registered config with ``n_layers`` cut to it, trained
through ``repro_torch.launch.train.make_trainer`` as ``chip_smoke.py``'s
train phase trains it (bf16 activations, float32 masters and AdamW moments,
its TRAIN_BATCH x TRAIN_SEQ, one repeated batch, no fault tolerance): the
parameter count, ``torch.cuda.max_memory_allocated`` and
``max_memory_reserved`` after STEPS steps (the AdamW moments exist from the
first), or "out of memory". The last line is one JSON object with every
depth's reading, the card's name and its memory. Needs a CUDA card.
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

from chip_smoke import TRAIN_BATCH, TRAIN_SEQ  # noqa: E402

STEPS = 2


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_trainer
    from repro_torch.utils.tree import tree_bytes

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_peak: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    out = []
    for layers in args.layers:
        cfg = dataclasses.replace(get_arch(args.arch), n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = dict(layers=layers, leftover_bytes=torch.cuda.memory_allocated())
        tr = None
        try:
            tr, _ = make_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, policy="none",
                                 repeat_batch=True, device="cuda")
            row["params"] = tree_bytes(tr.state["params"]) // 4
            tr.run(STEPS, failures=[])
            torch.cuda.synchronize()
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            row["reserved_peak_bytes"] = torch.cuda.max_memory_reserved()
        except torch.cuda.OutOfMemoryError:
            row["peak_bytes"] = None
            row["out_of_memory"] = True
        finally:
            if tr is not None:
                shutil.rmtree(tr.store.root, ignore_errors=True)
            del tr
        peak = row["peak_bytes"]
        print(f"{args.arch} at {layers} layers: "
              + (f"{row['params'] / 1e9:.3f} B parameters, " if "params" in row else "")
              + ("out of memory" if peak is None else
                 f"peak max_memory_allocated {peak / 2**30:.2f} GiB, max_memory_reserved "
                 f"{row['reserved_peak_bytes'] / 2**30:.2f} GiB of {total / 2**30:.2f}"))
        out.append(row)
    print(json.dumps({"arch": args.arch, "card": card, "total_bytes": total, "steps": STEPS,
                      "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "depths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
