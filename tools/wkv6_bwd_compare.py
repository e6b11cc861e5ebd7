#!/usr/bin/env python3
"""Time the wkv6 backward of two source trees side by side on one NVIDIA
card, with variants of this tree (other chunk sizes among them).

  python3 tools/wkv6_bwd_compare.py --other OTHER_TREE [--variant NAME ...]

OTHER_TREE is a checkout of another commit (``git archive <commit> | tar -x
-C build/parent``, a directory that .gitignore lists). A variant is this
tree with a few literal edits of its sources (VARIANTS), copied to
``build/wkv6_bwd_variants/<name>/``. The trees run in turns, then in the
reverse order (OTHER, THIS, ..., THIS, OTHER), each in a process of its own
that builds its own library from its own ``src/``. A process holds every
row's six outputs against ``wkv6_bwd_ref`` (max |kernel - plain| over
them), times the call on the device alone (``chip_smoke.device_ms``, the
profiler) and per call (``chip_smoke.time_ms``, CUDA events), and splits
its device time by kernel (``chip_smoke.device_top``). Inputs come from one
seed, so every tree sees the same numbers. Prints the card, one JSON line
a process, then the medians by tree and "other → tree" device ms.
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
VARIANT_DIR = ROOT / "build" / "wkv6_bwd_variants"

# name -> (B, H, S, N, dtype): rwkv6-1.6b's training shape (batch 4 x 512,
# 32 heads of 64), bf16 as the model trains and in float32, and bf16 at
# batch 1 and 8 (how each kernel's time scales with the blocks in flight)
ROWS = {
    "4b bf16 (4, 32, 512, 64)": (4, 32, 512, 64, "bfloat16"),
    "f32 (4, 32, 512, 64)": (4, 32, 512, 64, "float32"),
    "bf16 (1, 32, 512, 64)": (1, 32, 512, 64, "bfloat16"),
    "bf16 (8, 32, 512, 64)": (8, 32, 512, 64, "bfloat16"),
}


def chunk(tokens: int, *more) -> list:
    """The edits that set the backward's chunk to ``tokens``: the kernel's
    constant and the Python mirror that sizes the scratch, then ``more``."""
    return [("csrc/wkv6_bwd.cu", "constexpr int CHUNK = 128;", f"constexpr int CHUNK = {tokens};"),
            ("kernels/rwkv6.py", "BWD_CHUNK = 128", f"BWD_CHUNK = {tokens}"), *more]


# name -> [(file under src/repro_torch, text, replacement)]
VARIANTS = {
    "chunk 32": chunk(32),
    "chunk 64": chunk(64),
    "chunk 256": chunk(256),
    # the whole training sequence in one chunk: no chunk contributions and
    # no scan, the reverse pass one block of 8 warps a (b, h)
    "chunk 512": chunk(512),
    # the same with the reverse pass's registers uncapped (built for 8
    # warps an SM, not 16): as many warps a (b, h) and an SM as a reverse
    # pass of a block per 16-row slab with dv fused in, without the chunks
    "chunk 512, pass 2 uncapped": chunk(512, ("csrc/wkv6_bwd.cu",
                                              "constexpr int ROW_WARPS4 = 16;",
                                              "constexpr int ROW_WARPS4 = 8;")),
    # the second row pass sums the rows of 2 tokens together, not 1 (it
    # spills 8-12 bytes under its 128-register cap)
    "pass 2 batch 2": [("csrc/wkv6_bwd.cu", "constexpr int UR4 = 1;", "constexpr int UR4 = 2;")],
}

WORKER = r'''
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import _build, rwkv6

dev = torch.device("cuda", 0)
_build.lib()
out = {{"tree": {tree!r}}}
for name, (B, H, S, N, dtype) in {rows!r}.items():
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    f32, dt = torch.float32, getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=f32)

    r, k, v, dy = (0.5 * randn(B, S, H, N) for _ in range(4))
    wlog = -torch.exp(0.5 * randn(B, S, H, N) - 1)
    u = 0.3 * randn(H, N)
    st, ds_T = (0.1 * randn(B, H, N, N) for _ in range(2))
    r, k, v, dy = (t.to(dt).transpose(1, 2) for t in (r, k, v, dy))
    args = (r, k, v, wlog.transpose(1, 2), u, st, dy, ds_T)
    fn = lambda: rwkv6.wkv6_bwd(*args)
    got, want = fn(), rwkv6.wkv6_bwd_ref(*args)
    out[name] = dict(
        err=max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)),
        device_ms=cs.device_ms(fn), ms=cs.time_ms(fn),
        split=[(key.replace("void (anonymous namespace)::", "")[:48], round(ms, 5))
               for key, ms in cs.device_top(fn)])
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


def run(tree: Path, label: str) -> dict:
    code = WORKER.format(root=str(ROOT), src=str(tree / "src"), tree=label, rows=ROWS)
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
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of this tree (repeatable)")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    trees = {"other": args.other.resolve(), "this": ROOT}
    trees.update({name: make_variant(name) for name in args.variant})
    order = list(trees) + list(trees)[::-1]
    results = {label: [] for label in trees}
    for label in order:
        results[label].append(run(trees[label], label))
    print("median device ms / ms per call (max |kernel - plain| over the six outputs)")
    for name in ROWS:
        print(f"  {name}")
        med = {}
        for label in trees:
            rs = [r[name] for r in results[label]]
            med[label] = statistics.median(r["device_ms"] for r in rs)
            print(f"    {label:24s} {med[label]:.5f} / "
                  f"{statistics.median(r['ms'] for r in rs):.5f}  "
                  f"({max(r['err'] for r in rs):.3g})")
        for label in list(trees)[1:]:
            print(f"    device ms, other -> {label}: {med['other']:.5f} -> {med[label]:.5f}")
        for label in trees:  # the device ms by kernel of the first run of each tree
            print(f"    {label:24s} by kernel: {results[label][0][name]['split']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
