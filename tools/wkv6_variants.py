#!/usr/bin/env python3
"""Time variants of the CUDA wkv6 kernel side by side on one NVIDIA card.

  python3 tools/wkv6_variants.py [variant ...]     (default: all of VARIANTS)

A variant is the port's source (``src/repro_torch``) with a few literal
edits of ``csrc/wkv6.cu`` or ``csrc/wkv6.cuh`` (the tiles, which the
backward's row passes share), copied to ``build/wkv6_variants/<name>/`` (``main``
is the tree as it is). Each runs in a process of its own, which builds its
own library: ptxas's registers for the bf16 N = 64 kernel, then (tile
variants) y and the state against the plain version at rwkv6-1.6b's
prefill shape in bf16 and on a ragged float32 case, then the kernel's
device time at that shape (``chip_smoke.device_ms``, three readings). The
ablations drop a phase of the kernel to show what it costs; their outputs
are wrong by design and are not checked. Prints one JSON line a variant.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wkv6_variants"
TILE64 = "template <> struct Tile<64> { static constexpr int R = 4, C = 4, JC = 16; };"

# name -> (checked against the plain version, [(text in csrc/wkv6.cu or wkv6.cuh,
# replacement)])
VARIANTS = {
    "main": (True, []),
    "tile 8x4, slab 32": (True, [(TILE64, TILE64.replace("R = 4", "R = 8").replace("16", "32"))]),
    "tile 4x4, slab 32": (True, [(TILE64, TILE64.replace("JC = 16", "JC = 32"))]),
    "ablation: staging only": (False, [("for (int u0 = 0; u0 < n; u0 += U)",
                                        "for (int u0 = 0; u0 < 0; u0 += U)")]),
    "ablation: staged once": (False, [("    if (n == TT)\n      stage(",
                                       "    if (t0 > 0) {\n    } else if (n == TT)\n      stage(")]),
    "ablation: no group sums": (False, [("      group_sums<U, C, G>(acc, g);\n", "")]),
}

ONE = r'''
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import _build, rwkv6

dev = torch.device("cuda", 0)
_build.lib()
regs, name = None, ""
for line in _build.library_path().with_suffix(".log").read_text().splitlines():
    if "Function properties for" in line:
        name = line.split("Function properties for")[1]
    elif "Used" in line and "registers" in line and "wkv6_kernelI13__nv_bfloat16Li64" in name:
        regs = int(line.split("Used")[1].split("registers")[0])
g = torch.Generator(device=dev)
g.manual_seed(1234)

def inputs(B, S, H, N, dtype):
    """chip_smoke.py's wkv6 distributions, as (B, H, S, N) views."""
    r, k, v = ((0.5 * torch.randn((B, S, H, N), generator=g, device=dev)).to(dtype).transpose(1, 2)
               for _ in range(3))
    wlog = -torch.exp(0.5 * torch.randn((B, S, H, N), generator=g, device=dev) - 1).transpose(1, 2)
    u = 0.3 * torch.randn((H, N), generator=g, device=dev)
    st = 0.1 * torch.randn((B, H, N, N), generator=g, device=dev)
    return r, k, v, wlog, u, st

err = None
if {check}:  # chip_smoke.py's tolerances: y in r's type, the state in float32
    err = 0.0
    for shape, dtype, tol_y in (((4, 512, 32, 64), torch.bfloat16, cs.TOL["bfloat16"]),
                                ((2, 300, 8, 64), torch.float32, cs.WKV6_TOL_F32)):
        args = inputs(*shape, dtype)
        (y, st), (y_ref, st_ref) = rwkv6.wkv6(*args), rwkv6.wkv6_ref(*args)
        if cs.exceeds(y, y_ref, tol_y) or cs.exceeds(st, st_ref, cs.WKV6_TOL_F32):
            sys.exit(f"disagrees with the plain version at {{shape}} {{dtype}}")
        err = max(err, float((y.float() - y_ref.float()).abs().max()),
                  float((st - st_ref).abs().max()))
args = inputs(4, 512, 32, 64, torch.bfloat16)
print(json.dumps({{"registers": regs, "max_abs_err": err,
                  "device_ms": [cs.device_ms(lambda: rwkv6.wkv6(*args)) for _ in range(3)],
                  "ms": cs.time_ms(lambda: rwkv6.wkv6(*args))}}))
'''


def variant_src(name: str, edits) -> Path:
    if not edits:
        return ROOT / "src"
    dst = OUT / "".join(c if c.isalnum() else "_" for c in name) / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    files = [dst / "repro_torch" / "csrc" / f for f in ("wkv6.cu", "wkv6.cuh")]
    for old, new in edits:
        found = [f for f in files if f.read_text().count(old) == 1]
        if len(found) != 1:
            sys.exit(f"{name}: the text to edit is not in csrc/wkv6.cu{{,h}} exactly once: "
                     f"{old!r}")
        found[0].write_text(found[0].read_text().replace(old, new))
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    rc = 0
    for name in sys.argv[1:] or list(VARIANTS):
        check, edits = VARIANTS[name]
        src = variant_src(name, edits)
        res = subprocess.run([sys.executable, "-c", ONE.format(root=str(ROOT), src=str(src),
                                                               check=check)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(f"{name}: FAILED\n{res.stdout[-2000:]}{res.stderr[-3000:]}")
            rc = 1
            continue
        print(json.dumps({"variant": name, "card": card, **json.loads(res.stdout.splitlines()[-1])}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
