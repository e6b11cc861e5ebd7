#!/usr/bin/env python3
"""Time the rmsnorm backward kernel of several source trees side by side on
one NVIDIA card.

  python3 tools/rmsnorm_bwd_compare.py --other OTHER_TREE [--max-blocks N ...] \
      [--variant NAME ...]

OTHER_TREE is a checkout of another commit (``git archive <commit> | tar -x
-C build/parent``, a directory that .gitignore lists). ``--max-blocks N``
adds this tree with ``rmsnorm.BWD_MAX_BLOCKS`` set to N (the partition's cap
on blocks, hence on dscale's partial rows). A variant is this tree with a
few literal edits of ``csrc/rmsnorm.cu`` and ``kernels/rmsnorm.py``
(VARIANTS), copied to ``build/rmsnorm_variants/<name>/``. The trees run in turns, then in
the reverse order (OTHER, THIS, ..., THIS, OTHER), each in a process of its
own that builds its own library from its own ``src/``. A process holds
every row's dx and dscale against ``rmsnorm_bwd_ref`` (max |kernel -
plain|), times it on the device alone (``chip_smoke.device_ms``, the
profiler) and per call (``chip_smoke.time_ms``, CUDA events), splits its
device time by kernel (``chip_smoke.device_top``) and, in this tree, times
the library's ``F.rms_norm`` autograd backward on the device. Inputs come
from one seed, so every tree sees the same numbers. Prints the card, one
JSON line a process, then the medians by tree.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANT_DIR = ROOT / "build" / "rmsnorm_variants"

# name -> (rows, d, dtype): gemma-2b's training rows (batch 4 x 512) at its
# width and at recurrentgemma-9b's / deepseek-7b's
ROWS = {
    "1b bf16 (2048, 2048)": (2048, 2048, "bfloat16"),
    "1b' f32 (2048, 2048)": (2048, 2048, "float32"),
    "bf16 (2048, 4096)": (2048, 4096, "bfloat16"),
    "f32 (2048, 4096)": (2048, 4096, "float32"),
}

# name -> [(file under src/repro_torch, text, replacement)]
VARIANTS = {
    # a lane holds 32 elements: a row over half the warps, more registers
    "lane 32": [("csrc/rmsnorm.cu", "constexpr int BWD_LANE_ELEMS = 16;",
                 "constexpr int BWD_LANE_ELEMS = 32;"),
                ("kernels/rmsnorm.py", "BWD_LANE_ELEMS = 16", "BWD_LANE_ELEMS = 32")],
}

WORKER = r'''
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
sys.path.insert(0, {src!r})
import torch
import torch.nn.functional as F
from repro_torch.kernels import _build, rmsnorm as rn

dev = torch.device("cuda", 0)
_build.lib()
if {max_blocks!r}:
    rn.BWD_MAX_BLOCKS = {max_blocks!r}
out = {{"tree": {tree!r}}}
for name, (rows, d, dtype) in {rows!r}.items():
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    dt = getattr(torch, dtype)
    x, dy = (torch.randn((rows, d), generator=g, device=dev).to(dt) for _ in range(2))
    scale = torch.randn((d,), generator=g, device=dev)
    fn = lambda: rn.rmsnorm_bwd(x, scale, dy)
    got, want = fn(), rn.rmsnorm_bwd_ref(x, scale, dy)
    row = dict(dx_err=float((got[0].float() - want[0].float()).abs().max()),
               dscale_err=float((got[1] - want[1]).abs().max()),
               device_ms=cs.device_ms(fn), ms=cs.time_ms(fn),
               split=[(k.replace("void (anonymous namespace)::", "")[:40], round(ms, 5))
                      for k, ms in cs.device_top(fn)])
    if {library!r}:
        xg, wg = x.clone().requires_grad_(), scale.to(dt).requires_grad_()
        yg = F.rms_norm(xg, (d,), weight=wg, eps=1e-6)
        row["library_device_ms"] = cs.device_ms(
            lambda: torch.autograd.grad(yg, (xg, wg), dy, retain_graph=True))
    out[name] = row
print("RESULT " + json.dumps(out))
'''


def make_variant(name: str) -> Path:
    dst = VARIANT_DIR / name.replace(" ", "_")
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = dst / "src" / "repro_torch" / rel
        text = f.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in {rel}")
        f.write_text(text.replace(old, new))
    return dst


def run(tree: Path, label: str, max_blocks, library: bool) -> dict:
    code = WORKER.format(root=str(ROOT), src=str(tree / "src"), tree=label, rows=ROWS,
                         max_blocks=max_blocks, library=library)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"{label}: rc {res.returncode}\n{res.stdout[-2000:]}\n"
                         f"{res.stderr[-4000:]}")
    line = next(x for x in res.stdout.splitlines() if x.startswith("RESULT "))
    print(line[len("RESULT "):], flush=True)
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another tree (a checkout of another commit)")
    ap.add_argument("--max-blocks", type=int, action="append", default=[],
                    help="this tree with rmsnorm.BWD_MAX_BLOCKS set to N (repeatable)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of this tree (repeatable)")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    trees = {"other": (args.other.resolve(), None), "this": (ROOT, None)}
    trees.update({f"this, max blocks {n}": (ROOT, n) for n in args.max_blocks})
    trees.update({name: (make_variant(name), None) for name in args.variant})
    order = list(trees) + list(trees)[::-1]
    results = {label: [] for label in trees}
    for label in order:
        tree, max_blocks = trees[label]
        results[label].append(run(tree, label, max_blocks, library=label == "this"))
    print("median device ms / ms per call (max |kernel - plain| of dx, of dscale)")
    for name in ROWS:
        print(f"  {name}")
        for label in trees:
            rs = [r[name] for r in results[label]]
            print(f"    {label:24s} {statistics.median(r['device_ms'] for r in rs):.5f} / "
                  f"{statistics.median(r['ms'] for r in rs):.5f}  "
                  f"({max(r['dx_err'] for r in rs):.3g}, {max(r['dscale_err'] for r in rs):.3g})")
        lib = [r[name]["library_device_ms"] for r in results["this"]]
        print(f"    {'F.rms_norm autograd':24s} {statistics.median(lib):.5f} (device)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
