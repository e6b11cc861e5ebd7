#!/usr/bin/env python3
"""Time the flash-attention kernels of several source trees side by side on
one NVIDIA card.

  python3 tools/flash_compare.py --other OTHER_TREE      # this tree against another commit
  python3 tools/flash_compare.py --variant NAME [...]    # against variants of this tree

OTHER_TREE is a checkout of another commit (``git archive <commit> | tar -x
-C build/parent``, a directory that .gitignore lists). A variant is this
tree with a few literal edits of ``csrc/flash_attention.cu`` or of the
TF32 helpers it includes, ``csrc/tf32.cuh`` (VARIANTS), copied to
``build/flash_variants/<name>/``. The trees run in turns, then in
the reverse order (OTHER, THIS, THIS, OTHER), each in a process of its own
that builds its own library from its own ``src/``. A process holds each
float32 row, forward and backward, against the plain version (max |kernel -
plain|; the backward's over dq, dk and dv) and times every row of ROWS on
the device alone (``chip_smoke.device_ms``, the profiler) and per call
(``chip_smoke.time_ms``, CUDA events); against
another commit it also times the ``train_llm`` measured step surface at
gemma-2b's width at one shard (host clock). Inputs come from one seed, so
every tree sees the same numbers. Prints the card, one JSON line a
process, then the medians by tree.
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
VARIANT_DIR = ROOT / "build" / "flash_variants"

# name -> (kernel, dtype, (B, S, H, K, hd), window); causal throughout
ROWS = {
    "2a fwd bf16 gemma-2b (4,8,512,256)/(4,1)": ("fwd", "bfloat16", (4, 512, 8, 1, 256), 0),
    "2b fwd bf16 recurrentgemma-9b (4,16,2048,256)/(4,1) w2048":
        ("fwd", "bfloat16", (4, 2048, 16, 1, 256), 2048),
    "2c fwd f32 train_llm surface (8,8,2048,256)": ("fwd", "float32", (8, 2048, 8, 8, 256), 0),
    "2c' fwd f32 gemma-2b (4,8,512,256)/(4,1)": ("fwd", "float32", (4, 512, 8, 1, 256), 0),
    "2d fwd f32 (8,4,256,64)": ("fwd", "float32", (8, 256, 4, 4, 64), 0),
    "2e bwd bf16 gemma-2b (4,8,512,256)/(4,1)": ("bwd", "bfloat16", (4, 512, 8, 1, 256), 0),
    "2e' bwd bf16 recurrentgemma-9b w2048": ("bwd", "bfloat16", (4, 2048, 16, 1, 256), 2048),
    "2e'' bwd f32 (2,4,512,64)/(2,2)": ("bwd", "float32", (2, 512, 4, 2, 64), 0),
    "2e''' bwd f32 gemma-2b (4,8,512,256)/(4,1)": ("bwd", "float32", (4, 512, 8, 1, 256), 0),
}
F32_FWD = [name for name, (kernel, dtype, _, _) in ROWS.items()
           if kernel == "fwd" and dtype == "float32"]

SPLIT = "  lo = tf32_rna(x - __uint_as_float(hi));"
# name -> [(text in csrc/flash_attention.cu, or in the file VARIANT_FILES names, replacement)]
VARIANT_FILES = {"lo unmasked": "tf32.cuh"}
VARIANTS = {
    # 64 query rows and 4 warps a block: one warp a sub-partition
    "bq64": [("constexpr int F_BQ = 128;", "constexpr int F_BQ = 64;"),
             ("constexpr int F_THREADS = 256;", "constexpr int F_THREADS = 128;")],
    # lo passed with its half-place added but not cleared: the tensor cores
    # read a tf32 operand's top 19 bits only
    "lo unmasked": [(SPLIT, "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;")],
    # the two small products of S in the main accumulator; the Q·Kᵀ loop over
    # 16-column chunks unrolled once or four times (the source: twice)
    "one S accumulator": [("mma_tf32(cc[j], ", "mma_tf32(sc[j], ")],
    "qk unroll 1": [("#pragma unroll 2\n      for (int ch", "#pragma unroll 1\n      for (int ch")],
    "qk unroll 4": [("#pragma unroll 2\n      for (int ch", "#pragma unroll 4\n      for (int ch")],
}

WORKER = r'''
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import _build, flash_attention as fa
from repro_torch.workloads import registry as workloads

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
_build.lib()
out = {{"tree": {tree!r}}}
for name, (kernel, dtype, (B, S, H, K, hd), window) in {rows!r}.items():
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    dt = getattr(torch, dtype)

    def view(heads):
        x = torch.randn((B, S, heads, hd), generator=g, device=dev, dtype=torch.float32)
        return x.to(dt).transpose(1, 2)

    q, k, v = view(H), view(K), view(K)
    row = {{}}
    if kernel == "fwd":
        fn = lambda: fa.flash_attention(q, k, v, window=window)
        if dtype == "float32":
            err = fa.flash_attention(q, k, v, window=window) - fa.flash_attention_ref(
                q, k, v, window=window)
            row["max_abs_err"] = float(err.abs().max())
    else:
        o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
        dout = view(H)
        fn = lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, window=window)
        if dtype == "float32":
            want = fa.flash_attention_bwd_ref(q, k, v, o, dout, lse, window=window)
            row["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(fn(), want))
    iters = 5 if S * H >= 2048 * 16 else 20
    out[name] = dict(row, device_ms=cs.device_ms(fn, iters), ms=cs.time_ms(fn, iters))
if {surface!r}:
    rec = workloads.get("train_llm").measured_step_surface(
        n_shards=(1,), batch=8, seq_len=2048, heads=8, head_dim=256, n=3, warmup=1,
        device="cuda")
    out["train_llm step s, 1 shard"] = rec["step_time_s"][0]
print("RESULT " + json.dumps(out))
'''


def make_variant(name: str) -> Path:
    dst = VARIANT_DIR / name.replace(" ", "_")
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "csrc" / VARIANT_FILES.get(name, "flash_attention.cu")
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) < 1:
            raise SystemExit(f"variant {name}: {old!r} is not in csrc/{cu.name}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def run(tree: Path, label: str, rows: dict, surface: bool) -> dict:
    code = WORKER.format(root=str(ROOT), src=str(tree / "src"), tree=label, rows=rows,
                         surface=surface)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=1200)
    if res.returncode != 0:
        raise SystemExit(f"{label}: rc {res.returncode}\n{res.stdout[-2000:]}\n"
                         f"{res.stderr[-4000:]}")
    line = next(x for x in res.stdout.splitlines() if x.startswith("RESULT "))
    print(line[len("RESULT "):], flush=True)
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another tree (a checkout of another commit)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of this tree (repeatable); times the float32 forward rows")
    args = ap.parse_args()
    if bool(args.other) == bool(args.variant):
        ap.error("give --other or --variant")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    trees = {"this": ROOT}
    if args.other:
        trees = {"other": args.other.resolve(), "this": ROOT}
        rows, surface = ROWS, True
    else:
        trees.update({name: make_variant(name) for name in args.variant})
        rows, surface = {name: ROWS[name] for name in F32_FWD}, False
    order = list(trees) + list(trees)[::-1]
    results = {label: [] for label in trees}
    for label in order:
        results[label].append(run(trees[label], label, rows, surface))
    print("median device ms / ms per call (max |kernel - plain| of the float32 rows)")
    for name in rows:
        print(f"  {name}")
        for label in trees:
            dev = [r[name]["device_ms"] for r in results[label] if r[name]["device_ms"]]
            ms = [r[name]["ms"] for r in results[label]]
            err = max((r[name].get("max_abs_err", 0.0) for r in results[label]), default=0.0)
            print(f"    {label:28s} {statistics.median(dev) if dev else float('nan'):.5f} / "
                  f"{statistics.median(ms):.5f}" + (f"  ({err:.3g})" if err else ""))
    if surface:
        step = "train_llm step s, 1 shard"
        print(f"  {step}: " + ", ".join(
            f"{label} {statistics.median(r[step] for r in results[label]):.6f}"
            for label in trees))
    return 0


if __name__ == "__main__":
    sys.exit(main())
