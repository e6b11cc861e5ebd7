"""The dry run's markdown tables from its JSONs (counterpart of
``repro/roofline/report.py``): the same tables, their HBM column against
the H100's 80 GB (``launch/dryrun.py`` sets ``fits_hbm`` against
``H100_SXM.hbm_bytes``), the summary counting trace seconds where the
reference counts compile seconds.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dryrun_dir):
    cells = {}
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        r = json.load(open(p))
        key = (r.get("arch"), r.get("shape"), r.get("mesh"), r.get("variant"))
        cells[key] = r
    return cells


def fmt(x, nd=3):
    return f"{x:.{nd}f}" if isinstance(x, (int, float)) else str(x)


def roofline_table(cells, mesh="single", variant="baseline"):
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck | "
        "roofline frac | useful FLOP ratio | peak GB/dev | fits 80GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m, v), r in sorted(cells.items()):
        if m != mesh or v != variant:
            continue
        if "skipped" in r:
            lines.append(
                f"| {arch} | {shape} | — | — | — | skipped-by-design | — | — | — | — |"
            )
            continue
        if "roofline" not in r:
            lines.append(f"| {arch} | {shape} | ERROR | | | | | | | |")
            continue
        rf = r["roofline"]
        mem = r["memory"]
        lines.append(
            f"| {arch} | {shape} | {fmt(rf['compute_s'],4)} | {fmt(rf['memory_s'])} | "
            f"{fmt(rf['collective_s'])} | {rf['bottleneck']} | "
            f"{fmt(rf['roofline_fraction'])} | {fmt(r.get('useful_compute_ratio',0),2)} | "
            f"{fmt(mem['peak_per_device']/1e9,1)} | "
            f"{'yes' if mem['fits_hbm'] else 'no'} |"
        )
    return "\n".join(lines)


def dryrun_summary(cells):
    n_ok = n_skip = n_err = 0
    trace_total = 0.0
    for r in cells.values():
        if "skipped" in r:
            n_skip += 1
        elif "roofline" in r:
            n_ok += 1
            trace_total += r.get("trace_s", 0)
        else:
            n_err += 1
    return n_ok, n_skip, n_err, trace_total


def perf_rows(cells, arch, shape="train_4k", mesh="single"):
    out = []
    for (a, s, m, v), r in sorted(cells.items()):
        if a != arch or s != shape or m != mesh or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {v} | {fmt(rf['compute_s'],3)} | {fmt(rf['memory_s'],3)} | "
            f"{fmt(rf['collective_s'],3)} | {rf['bottleneck']} | "
            f"{fmt(rf['roofline_fraction'],3)} | "
            f"{fmt(r['memory']['peak_per_device']/1e9,1)} |"
        )
    hdr = ("| variant | compute_s | memory_s | collective_s | bottleneck | frac | peak GB |\n"
           "|---|---|---|---|---|---|---|")
    return hdr + "\n" + "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    cells = load(args.dir)
    n_ok, n_skip, n_err, ct = dryrun_summary(cells)
    print(f"## cells: {n_ok} traced, {n_skip} skipped-by-design, {n_err} errors; "
          f"total trace {ct/60:.1f} min\n")
    print("### single-pod (16x16) baseline roofline\n")
    print(roofline_table(cells, "single", "baseline"))
    print("\n### multi-pod (2x16x16) baseline roofline\n")
    print(roofline_table(cells, "multi", "baseline"))
    for arch in ("gemma-2b", "olmoe-1b-7b", "kimi-k2-1t-a32b"):
        print(f"\n### hillclimb: {arch} train_4k\n")
        print(perf_rows(cells, arch))


if __name__ == "__main__":
    main()
