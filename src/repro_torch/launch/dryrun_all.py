"""Drive the full (arch x shape x mesh) dry-run sweep, one subprocess per
cell (a fresh fake process group per cell; resumable: existing JSONs are
skipped). The counterpart of ``repro/launch/dryrun_all.py``; the cells run
``python -m repro_torch.launch.dryrun`` on any host, no card needed. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh single|multi|both]
      [--archs a,b,...] [--out experiments/dryrun_torch]

``--archs`` defaults to every arch of the reference's registry, as the
reference sweeps: the ones the port does not run give ``error`` cells.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

#: every arch of the reference's registry (``repro/configs``), all of them
#: the port's
ARCHS = ("deepseek-7b", "gemma-2b", "granite-3-2b", "kimi-k2-1t-a32b", "olmoe-1b-7b",
         "phi-3-vision-4.2b", "qwen2.5-3b", "recurrentgemma-9b", "rwkv6-1.6b", "whisper-tiny")
SRC = str(Path(__file__).resolve().parents[2])


def cell_list(archs, meshes):
    from repro_torch.configs import SHAPES

    cells = []
    for mesh in meshes:
        for arch in archs:
            for shape in SHAPES:
                cells.append((arch, shape, mesh))
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--archs", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    archs = args.archs.split(",") if args.archs else list(ARCHS)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = cell_list(archs, meshes)
    os.makedirs(args.out, exist_ok=True)

    t_start = time.time()
    for i, (arch, shape, mesh) in enumerate(cells):
        out = os.path.join(args.out, f"{arch}.{shape}.{mesh}.{args.variant}.json")
        if os.path.exists(out):
            try:
                json.load(open(out))
                print(f"[{i+1}/{len(cells)}] skip (exists): {out}", flush=True)
                continue
            except Exception:
                pass
        t0 = time.time()
        cmd = [
            sys.executable,
            "-m",
            "repro_torch.launch.dryrun",
            "--arch",
            arch,
            "--shape",
            shape,
            "--mesh",
            mesh,
            "--variant",
            args.variant,
            "--out",
            out,
        ]
        print(
            f"[{i+1}/{len(cells)}] {arch} {shape} {mesh} ...",
            flush=True,
        )
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                text=True,
                timeout=args.timeout,
                env={**os.environ, "PYTHONPATH": os.pathsep.join(
                    p for p in (SRC, os.environ.get("PYTHONPATH")) if p)},
            )
            if proc.returncode != 0:
                err = proc.stderr.strip().splitlines()[-15:]
                with open(out, "w") as f:
                    json.dump(
                        {
                            "arch": arch,
                            "shape": shape,
                            "mesh": mesh,
                            "variant": args.variant,
                            "error": "\n".join(err),
                        },
                        f,
                        indent=2,
                    )
                print(f"    FAILED ({time.time()-t0:.0f}s): {err[-1] if err else '?'}", flush=True)
            else:
                r = json.load(open(out))
                if "skipped" in r:
                    print(f"    skipped-by-design: {r['skipped']}", flush=True)
                elif "error" in r:
                    print(f"    error: {r['error']}", flush=True)
                else:
                    rf = r.get("roofline", {})
                    print(
                        f"    ok {time.time()-t0:.0f}s trace={r.get('trace_s',0):.0f}s "
                        f"bottleneck={rf.get('bottleneck')} frac={rf.get('roofline_fraction',0):.3f}",
                        flush=True,
                    )
        except subprocess.TimeoutExpired:
            with open(out, "w") as f:
                json.dump(
                    {
                        "arch": arch,
                        "shape": shape,
                        "mesh": mesh,
                        "variant": args.variant,
                        "error": f"timeout>{args.timeout}s",
                    },
                    f,
                    indent=2,
                )
            print("    TIMEOUT", flush=True)
    print(f"sweep done in {(time.time()-t_start)/60:.1f} min", flush=True)


if __name__ == "__main__":
    main()
