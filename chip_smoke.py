#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a, and
   checks in the SASS (cuobjdump) that the bf16 flash_attention kernel
   runs on the tensor cores (HGMMA);
3. kernels: each of the five kernels against its plain torch version on
   the card, at the serving paths' shapes (gemma-2b: bf16, batch 4, prompt
   512, cache 544; rwkv6-1.6b: wkv6 at (4, 32, 512, 64); recurrentgemma-9b:
   flash_attention at (4, 16, 2048, 256), flash_decode over a 2048-slot
   ring, rmsnorm at width 4096, rglru at (4, 2048, 4096) with float32 and
   with bf16 inputs) plus ragged / window / ring / empty-row /
   strong-decay / float32 / head-dim cases, the reference's own test
   shapes of wkv6 (head sizes 8, 16, 32) and rglru, wkv6's S = 1 and
   odd-grid cases and the check that its serve grid is one wave, and
   rglru's S = 1, short-tile, unaligned-row, long-sequence and
   extreme-decay cases;
   each timed per call with CUDA events and on the device alone with
   torch.profiler, beside its plain version, its bound and, where one
   exists, one PyTorch library call;
4. serve: gemma-2b (prompt 512), rwkv6-1.6b (prompt 512) and
   recurrentgemma-9b (prompt 2048, its window) at full width, random
   weights from a seed, through ``repro_torch.launch.serve``: 4 requests,
   32 new tokens each. For each: the exact kernel launch counts of the run
   (counts set to 0 just before it), finite logits, the prefill and the
   first decode steps against the plain versions on the same weights, and
   a profile of a prefill and a few decode steps. Then each of the three at
   full width in float32, kernel path against plain path (5 tokens), and a
   reduced float32 model of each family (recurrentgemma with 5 layers, so
   that its remainder stack runs) on the card against the same weights on
   the CPU;
5. prints the ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): memory rate and peak rates by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_kernels.py tolerances
DECODE_TOL_F32 = 3e-5
# flash_decode bf16 against its plain version: absolute 4e-3 (the readings
# are <= 1e-3 at the decode shapes) plus one bf16 step (2^-7) of the value,
# the most that rounding the same float32 result two ways can differ by.
# At recurrentgemma-9b's shape the outputs are ~0.03: a dropped chunk of
# the cache reads well above this limit (the decode rows check that).
DECODE_TOL_BF16 = (4e-3, 2.0 ** -7)
# Greedy tokens of the kernel path and the plain path must agree; where they
# differ, the plain path must rank the kernel's token within TOKEN_TIE_TOL
# of its top logit: a near-tie, not an error. In bf16 the two paths' logits
# drift apart with depth as one-step roundings compound. Both limits are
# about twice the largest reading over the prefill and 4 decode steps of
# the seed-0 serve runs on an NVIDIA H100 80GB HBM3 (700 W):
#   arch               largest gap   max |kernel - plain|
#   gemma-2b           0.03125       0.1133
#   rwkv6-1.6b         0.04688       0.1904
#   recurrentgemma-9b  0.09375       0.2812
# gemma-2b's and rwkv6-1.6b's near-tie is the tighter 0.0625, two bf16
# steps for logits in [4, 8). The float32 full-width phase shows that the kernels
# themselves agree (tokens equal, logits within 1e-3) at the same shapes.
TOKEN_TIE_TOL = {"gemma-2b": 0.0625, "rwkv6-1.6b": 0.0625, "recurrentgemma-9b": 0.1875}
BF16_LOGITS_DRIFT = {"gemma-2b": 0.25, "rwkv6-1.6b": 0.4, "recurrentgemma-9b": 0.55}
LOGITS_TOL_F32 = 1e-4  # reduced float32 model, card kernels vs CPU plain versions
LOGITS_TOL_FULL_F32 = 1e-3  # full-width float32 model, card kernels vs plain versions

ARCH, BATCH, PROMPT, NEW = "gemma-2b", 4, 512, 32
# the serve runs: (arch, prompt length); recurrentgemma's prompt is its window
SERVES = (("gemma-2b", 512), ("rwkv6-1.6b", 512), ("recurrentgemma-9b", 2048))
WKV6_TOL_F32 = 3e-5  # tests/test_kernels.py: y and the float32 state against the chunked form
WKV6_TOL_STRONG_DECAY = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Device time per call: the kernels' own time in a torch.profiler trace
    of ``iters`` calls, summed and divided by ``iters``. Unlike time_ms it
    leaves out the host's launch gaps. A trace now and then records no
    device activity at all: up to three traces are taken, and None is
    returned when none of them shows device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA")
        if us > 0:
            return us / 1e3 / iters
    return None


def timings(kernel, plain, library=None, iters: int = 20) -> dict:
    """A row's times: per call (CUDA events over back-to-back calls) and on
    the device alone (profiler), for the kernel and the library call, and
    per call for the plain version."""
    return dict(ms=time_ms(kernel, iters), device_ms=device_ms(kernel, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=None if library is None else time_ms(library, iters),
                library_device_ms=None if library is None else device_ms(library, iters))


def sass_check(lib_path: Path) -> None:
    """The bf16 flash_attention kernel must run on the tensor cores: count
    HGMMA / HMMA instructions in the SASS of each flash_tc_kernel
    instantiation (cuobjdump on the built library)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if "flash_tc_kernel" in name else None
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[name][op] += 1
    print(f"sass: {len(counts)} flash_tc_kernel instantiation(s)")
    for fn, c in counts.items():
        print(f"  {fn}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
    if not counts or not all(c["HGMMA"] + c["HMMA"] > 0 for c in counts.values()):
        fail("the bf16 flash_attention kernel has no tensor-core instruction in its SASS")


def ptxas_report(lib_path: Path, kernel: str) -> None:
    """Registers and spill bytes of each instantiation of ``kernel``, from
    the ptxas output the build keeps beside the library."""
    name = None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            name = name if kernel in name else None
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            print(f"ptxas: {name[:100]}: {regs} registers; {spills}")
            name = None


def compare(name: str, got, want, tol) -> float:
    """max |got - want|; fails beyond atol + rtol * |want|, where ``tol`` is
    (atol, rtol) or one number for both."""
    import torch

    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_err = float(err.max())
    if worst > atol:
        fail(f"{name}: max |kernel - plain| {max_err:.3g} exceeds atol {atol}, rtol {rtol}")
    print(f"  {name}: max_abs_err {max_err:.3g} (tol {tol})")
    return max_err


def exceeds(got, want, tol) -> bool:
    """Whether ``compare`` would fail ``got`` against ``want``."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return float(((got.float() - want.float()).abs() - rtol * want.float().abs()).max()) > atol


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ring_kpos(B: int, W: int, pos: int, device):
    """kpos of a ring of W slots after positions 0..pos were written at
    slot p % W (the latest write wins); never-written slots are -1."""
    import torch

    s = torch.arange(W, device=device)
    latest = s + W * torch.div(pos - s, W, rounding_mode="floor")
    kp = torch.where(s <= pos, latest, torch.full_like(s, -1))
    return kp.to(torch.int32).expand(B, W).contiguous()


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    cfg = get_arch(ARCH)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = BATCH, PROMPT
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    rows = []

    # -- rmsnorm: (B*S, d) rows, as in every prefill norm --------------------
    print("kernel rmsnorm")
    x, scale = randn(B * S, d), randn(d, dtype=torch.float32)
    err = compare("rmsnorm bf16 (2048, 2048)", rn.rmsnorm(x, scale), rn.rmsnorm_ref(x, scale),
                  TOL["bfloat16"])
    xf, sf = randn(37, 100, dtype=torch.float32), randn(100, dtype=torch.float32)
    compare("rmsnorm f32 (37, 100) unvectorised", rn.rmsnorm(xf, sf), rn.rmsnorm_ref(xf, sf),
            TOL["float32"])
    xd = randn(B, 1, d)
    compare("rmsnorm bf16 decode (4, 1, 2048)", rn.rmsnorm(xd, scale), rn.rmsnorm_ref(xd, scale),
            TOL["bfloat16"])
    for shape in ((B * S, 4096), (16, 4096), (B, 1, 4096)):  # recurrentgemma-9b's width
        xr_, sr_ = randn(*shape), randn(4096, dtype=torch.float32)
        compare(f"rmsnorm bf16 {shape}", rn.rmsnorm(xr_, sr_), rn.rmsnorm_ref(xr_, sr_),
                TOL["bfloat16"])
    b_ms, b_by = bound(2 * nbytes(x) + nbytes(scale), 4 * x.numel(), "float32")
    w16 = scale.to(bf)
    rows.append(dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:27", shape="x (2048, 2048) bf16",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: rn.rmsnorm(x, scale), lambda: rn.rmsnorm_ref(x, scale),
                  lambda: F.rms_norm(x, (d,), weight=w16, eps=1e-6)),
    ))

    # -- flash_attention: prefill, q/k/v as transposed (B, S, h, hd) views ---
    print("kernel flash_attention")

    def qkv(B_, S_, H_, K_, hd_, dtype=bf):
        q5, k5, v5 = randn(B_, S_, H_, hd_, dtype=dtype), randn(B_, S_, K_, hd_, dtype=dtype), \
            randn(B_, S_, K_, hd_, dtype=dtype)
        return q5.transpose(1, 2), k5.transpose(1, 2), v5.transpose(1, 2)

    q, k, v = qkv(B, S, H, K, hd)
    err = compare("flash_attention bf16 causal (4,8,512,256)/(4,1,512,256)",
                  fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v), TOL["bfloat16"])
    qr, kr, vr = qkv(2, 300, H, K, hd)
    compare("flash_attention bf16 causal ragged S=300", fa.flash_attention(qr, kr, vr),
            fa.flash_attention_ref(qr, kr, vr), TOL["bfloat16"])
    compare("flash_attention bf16 window 128", fa.flash_attention(q, k, v, window=128),
            fa.flash_attention_ref(q, k, v, window=128), TOL["bfloat16"])
    qf, kf, vf = qkv(1, 200, 4, 2, 64, dtype=torch.float32)
    compare("flash_attention f32 causal GQA (1,4,200,64)/(1,2,200,64)",
            fa.flash_attention(qf, kf, vf), fa.flash_attention_ref(qf, kf, vf), TOL["float32"])
    compare("flash_attention f32 window 48", fa.flash_attention(qf, kf, vf, window=48),
            fa.flash_attention_ref(qf, kf, vf, window=48), TOL["float32"])
    for hd_ in fa.HEAD_DIMS[:-1]:  # the other bf16 instantiations, ragged S = 200
        qh, kh, vh = qkv(1, 200, 4, 2, hd_)
        compare(f"flash_attention bf16 GQA hd {hd_} (1,4,200)/(1,2,200) window 80",
                fa.flash_attention(qh, kh, vh, window=80),
                fa.flash_attention_ref(qh, kh, vh, window=80), TOL["bfloat16"])
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * hd * pairs * B * H, "bfloat16")
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        shape="q (4,8,512,256), k/v (4,1,512,256) bf16, causal", max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)),
    ))
    # recurrentgemma-9b's attn_local layers: 16 query heads on one KV head,
    # window 2048 = S, so every causal pair is in the window
    rg = get_arch("recurrentgemma-9b")
    Sg, Hg = rg.window, rg.n_heads
    qg, kg, vg = qkv(B, Sg, Hg, rg.n_kv_heads, rg.resolved_head_dim)
    err = compare(f"flash_attention bf16 window {Sg} (4,16,2048,256)/(4,1,2048,256)",
                  fa.flash_attention(qg, kg, vg, window=Sg),
                  fa.flash_attention_ref(qg, kg, vg, window=Sg), TOL["bfloat16"])
    pairs = Sg * (Sg + 1) // 2
    b_ms, b_by = bound(2 * nbytes(qg) + nbytes(kg, vg),
                       4 * rg.resolved_head_dim * pairs * B * Hg, "bfloat16")
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        shape="q (4,16,2048,256), k/v (4,1,2048,256) bf16, causal, window 2048",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: fa.flash_attention(qg, kg, vg, window=Sg),
                  lambda: fa.flash_attention_ref(qg, kg, vg, window=Sg),
                  lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                         enable_gqa=True), iters=5),
    ))
    del qg, kg, vg

    # -- flash_decode: the model's (B, W, n, hd) cache read as a view --------
    decode_cases(dev, randn)
    rows += decode_rows(dev, randn)
    rows.append(wkv6_row(randn, dev))
    rows += rglru_row(randn, dev)
    def fmt(t):
        return "none" if t is None else f"{t:.5f}"

    for r in rows:
        print(f"  {r['name']} {r['shape']}: {r['ms']:.5f} ms per call, {fmt(r['device_ms'])} on "
              f"the device (plain {r['plain_ms']:.4f}; library {fmt(r['library_ms'])} per call, "
              f"{fmt(r['library_device_ms'])} on the device; bound {r['bound_ms']:.5f} by "
              f"{r['bound_by']})")
    return rows


def decode_cases(dev, randn):
    """flash_decode against its plain version off the two timed shapes:
    ragged, windowed, wrapped, empty and float32 caches; and the grid at
    gemma-2b's shape fills the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da

    print("kernel flash_decode")
    cfg = get_arch(ARCH)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, W = BATCH, PROMPT + NEW
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_chunks = da.decode_plan(W, B * K, sms)
    grid = -(-n_chunks // da.CLUSTER) * da.CLUSTER * B * K
    print(f"  flash_decode grid at gemma-2b's shape: {n_chunks} chunks of {chunk} slots x "
          f"{B * K} rows = {n_chunks * B * K} blocks ({grid} with the cluster padding) on "
          f"{sms} SMs")
    if n_chunks * B * K < sms:
        fail(f"flash_decode: {n_chunks * B * K} blocks at gemma-2b's shape, fewer than {sms} SMs")
    pos = PROMPT + 3
    kc, vc = randn(B, W, K, hd).transpose(1, 2), randn(B, W, K, hd).transpose(1, 2)
    kpos = ring_kpos(B, W, pos, dev)
    qd = randn(B, 1, H, hd)[:, 0]

    def check(name, q, k, v, kp, p, tol=DECODE_TOL_BF16, window=0, calls=1):
        """``calls`` back-to-back calls, each held against the plain version:
        every call reuses the counters and scratch of the one before."""
        want = da.flash_decode_ref(q, k, v, kp, p, window=window)
        got = [da.flash_decode(q, k, v, kp, p, window=window) for _ in range(calls)]
        bad = [o for o in got if exceeds(o, want, tol)]
        compare(f"flash_decode {name}" + (f", {calls} calls" if calls > 1 else ""),
                (bad or got)[0], want, tol)

    check("bf16 window 128", qd, kc, vc, kpos, pos, window=128)
    check("bf16 window 40 (whole chunks empty)", qd, kc, vc, kpos, pos, window=40)
    kring = ring_kpos(B, 128, 700, dev)  # wrapped ring of 128 slots
    check("bf16 wrapped ring W=128", qd, kc[:, :, :128], vc[:, :, :128], kring, 700)
    check("bf16 wrapped ring W=128 window 24", qd, kc[:, :, :128], vc[:, :, :128], kring, 700,
          window=24)
    check("bf16 ragged cache 300", qd, kc[:, :, :300], vc[:, :, :300], kpos[:, :300], 299)
    empty_row = kpos.clone()
    empty_row[1] = -1  # batch row 1 has no valid slot: the mean of V
    check("bf16 batch row 1 with no valid slot", qd, kc, vc, empty_row, pos)
    qf = randn(2, 4, 64, dtype=torch.float32)
    kf = randn(2, 200, 2, 64, dtype=torch.float32).transpose(1, 2)
    vf = randn(2, 200, 2, 64, dtype=torch.float32).transpose(1, 2)
    kpf = ring_kpos(2, 200, 150, dev)
    check("f32 GQA (2,4,64) cache 200", qf, kf, vf, kpf, 150, DECODE_TOL_F32)
    check("f32 no valid slot in any row", qf, kf, vf, torch.full_like(kpf, -1), 150,
          DECODE_TOL_F32)
    for hd_ in da.HEAD_DIMS[:-1]:  # the other bf16 head dims, 16 heads on one KV head
        qh, kh, vh = randn(2, 16, hd_), randn(2, 1, 100, hd_), randn(2, 1, 100, hd_)
        check(f"bf16 (2,16,{hd_}) cache 100 window 50", qh, kh, vh, ring_kpos(2, 100, 130, dev),
              130, window=50)
    # groups that are not a multiple of the cluster size, over several
    # clusters: a rank's column slice then starts inside a head
    for B_, H_, K_, S_, hd_, dt in ((4, 4, 4, 600, 64, torch.bfloat16),
                                    (2, 4, 2, 1000, 128, torch.bfloat16),
                                    (2, 4, 2, 1000, 128, torch.float32),
                                    (4, 4, 1, 300, 16, torch.bfloat16)):
        _, n_ = da.decode_plan(S_, B_ * K_, sms)
        qg = randn(B_, H_, hd_, dtype=dt)
        kg_, vg_ = (randn(B_, S_, K_, hd_, dtype=dt).transpose(1, 2) for _ in range(2))
        check(f"{'bf16' if dt == torch.bfloat16 else 'f32'} g {H_ // K_} ({B_},{H_},{hd_}) "
              f"cache {S_}, {-(-n_ // da.CLUSTER)} clusters", qg, kg_, vg_,
              ring_kpos(B_, S_, S_ + 7, dev), S_ + 7,
              DECODE_TOL_BF16 if dt == torch.bfloat16 else DECODE_TOL_F32, calls=20)
    # two streams at once: each has its own counters and scratch
    side = torch.cuda.Stream(dev)
    want = da.flash_decode_ref(qd, kc, vc, kpos, pos)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(10):
        outs.append(da.flash_decode(qd, kc, vc, kpos, pos))
        with torch.cuda.stream(side):
            outs.append(da.flash_decode(qd, kc, vc, kpos, pos))
    torch.cuda.current_stream(dev).wait_stream(side)
    worst = max(float((o.float() - want.float()).abs().max()) for o in outs)
    if any(exceeds(o, want, DECODE_TOL_BF16) for o in outs):
        fail(f"flash_decode on two streams at once: max |kernel - plain| {worst:.3g}")
    print(f"  flash_decode bf16 on two streams at once, 20 calls: max_abs_err {worst:.3g} "
          f"(tol {DECODE_TOL_BF16})")


def decode_rows(dev, randn):
    """flash_decode at the two decode shapes of the serve runs, against its
    plain version, timed beside masked SDPA: gemma-2b (8 heads on one KV
    head, cache 544, 516 valid) and recurrentgemma-9b (16 heads on one KV
    head, a full 2048-slot ring, window 2048)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da

    rows = []
    for arch, W, pos, window in ((ARCH, PROMPT + NEW, PROMPT + 3, 0),
                                 ("recurrentgemma-9b", 2048, 2048 + 3, 2048)):
        cfg = get_arch(arch)
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        assert not window or window == cfg.window
        kc, vc = randn(BATCH, W, K, hd).transpose(1, 2), randn(BATCH, W, K, hd).transpose(1, 2)
        kpos = ring_kpos(BATCH, W, pos, dev)
        qd = randn(BATCH, H, hd)
        valid = (kpos >= 0) & (kpos <= pos)
        if window:
            valid &= kpos > pos - window
        n_valid = int(valid.sum())  # (row, slot) pairs the data needs
        shape = f"q ({BATCH},{H},{hd}) bf16, cache {W} slots, {n_valid // BATCH} valid" + (
            f", window {window}" if window else "")
        want = da.flash_decode_ref(qd, kc, vc, kpos, pos, window=window)
        err = compare(f"flash_decode {shape}",
                      da.flash_decode(qd, kc, vc, kpos, pos, window=window), want,
                      DECODE_TOL_BF16)
        # what the limit would see: the plain version with one chunk of valid
        # slots dropped (the rule's chunk at this shape, the first one)
        chunk, _ = da.decode_plan(W, BATCH * K, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
        s0 = 0
        if not bool(valid[:, s0:s0 + chunk].all()):
            fail(f"flash_decode {shape}: the chunk at slot {s0} is not all valid")
        dropped = kpos.clone()
        dropped[:, s0:s0 + chunk] = -1
        drop = da.flash_decode_ref(qd, kc, vc, dropped, pos, window=window)
        drop_err = float((drop.float() - want.float()).abs().max())
        print(f"  a dropped chunk of {chunk} slots ({s0}..{s0 + chunk - 1}) reads max_abs_err "
              f"{drop_err:.3g} against the limit {DECODE_TOL_BF16}")
        if not exceeds(drop, want, DECODE_TOL_BF16):
            fail(f"flash_decode {shape}: a dropped chunk stays inside {DECODE_TOL_BF16}")
        b_ms, b_by = bound(2 * nbytes(qd) + 2 * n_valid * K * hd * kc.element_size()
                           + nbytes(kpos), 4 * hd * H * n_valid, "bfloat16")
        mask, q4 = valid[:, None, None, :], qd[:, :, None]
        rows.append(dict(
            name="flash_decode", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:60", shape=shape, max_abs_err=err,
            bound_ms=b_ms, bound_by=b_by,
            **timings(lambda: da.flash_decode(qd, kc, vc, kpos, pos, window=window),
                      lambda: da.flash_decode_ref(qd, kc, vc, kpos, pos, window=window),
                      lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                             enable_gqa=True)),
        ))
    return rows


def wkv6_row(randn, dev):
    """wkv6 at rwkv6-1.6b's prefill shape, r/k/v/wlog as the (B, S, H, N)
    views the model passes, after checking that the built kernel's launch
    plan is launch_plan's and that its serve grid is resident in one wave;
    then the ragged, odd-grid, S = 1, strong-decay and reference-shape
    cases. No single PyTorch call computes it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rwkv6

    print("kernel wkv6")
    cfg = get_arch("rwkv6-1.6b")
    H, N = cfg.n_heads, cfg.resolved_head_dim

    def inputs(B_, S_, H_, N_, dtype, strong_decay=False):
        """tests/test_kernels.py's distributions, as (B, H, S, N) views."""
        r, k, v = (0.5 * randn(B_, S_, H_, N_, dtype=torch.float32) for _ in range(3))
        if strong_decay:
            wlog = torch.full((B_, S_, H_, N_), -8.0, dtype=torch.float32, device=dev)
            u = torch.zeros((H_, N_), dtype=torch.float32, device=dev)
            st = torch.zeros((B_, H_, N_, N_), dtype=torch.float32, device=dev)
        else:
            wlog = -torch.exp(0.5 * randn(B_, S_, H_, N_, dtype=torch.float32) - 1)
            u = 0.3 * randn(H_, N_, dtype=torch.float32)
            st = 0.1 * randn(B_, H_, N_, N_, dtype=torch.float32)
        r, k, v = (t.to(dtype).transpose(1, 2) for t in (r, k, v))
        return r, k, v, wlog.transpose(1, 2), u, st

    def check(name, args, tol_y, tol_state):
        y, st = rwkv6.wkv6(*args)
        y_ref, st_ref = rwkv6.wkv6_ref(*args)
        return max(compare(f"{name} y", y, y_ref, tol_y),
                   compare(f"{name} state", st, st_ref, tol_state))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        blocks, threads, smem = rwkv6.launch_plan(BATCH, H, N)
        got = rwkv6.device_plan(dtype, N)
        print(f"  wkv6 grid at ({BATCH},{H},{PROMPT},{N}) {dtype}: {blocks} blocks of "
              f"{threads} threads, {smem} B shared, {got['per_sm']} resident per SM x {sms} "
              f"SMs = {got['per_sm'] * sms}")
        if (got["threads"], got["smem"], got["slabs"] * BATCH * H) != (threads, smem, blocks):
            fail(f"wkv6 {dtype}: the kernel's plan {got} differs from launch_plan's "
                 f"{(blocks, threads, smem)}")
        if blocks > got["per_sm"] * sms:
            fail(f"wkv6 {dtype}: {blocks} blocks do not fit one wave ({got['per_sm']} per SM)")
    args = inputs(BATCH, PROMPT, H, N, torch.bfloat16)
    err = check(f"wkv6 bf16 r/k/v ({BATCH},{H},{PROMPT},{N})", args, TOL["bfloat16"],
                WKV6_TOL_F32)
    check("wkv6 f32 ragged S=300 (2,8,300,64)", inputs(2, 300, 8, N, torch.float32),
          WKV6_TOL_F32, WKV6_TOL_F32)
    check("wkv6 f32 (3,5,130,64): B*H*slabs = 60 blocks, a short tile",
          inputs(3, 130, 5, N, torch.float32), WKV6_TOL_F32, WKV6_TOL_F32)
    for tag, dtype, tol_y in (("f32", torch.float32, WKV6_TOL_F32),
                              ("bf16 r/k/v", torch.bfloat16, TOL["bfloat16"])):
        check(f"wkv6 {tag} S=1 (2,4,1,64)", inputs(2, 1, 4, N, dtype), tol_y, WKV6_TOL_F32)
    strong = inputs(1, 256, 2, N, torch.float32, strong_decay=True)
    check("wkv6 f32 wlog=-8 (1,2,256,64)", strong, WKV6_TOL_STRONG_DECAY, WKV6_TOL_STRONG_DECAY)
    for B_, H_, S_, N_ in ((1, 1, 32, 8), (2, 4, 128, 16), (1, 2, 96, 32)):  # tests/test_kernels.py
        check(f"wkv6 f32 ({B_},{H_},{S_},{N_})", inputs(B_, S_, H_, N_, torch.float32),
              WKV6_TOL_F32, WKV6_TOL_F32)
        check(f"wkv6 bf16 r/k/v ({B_},{H_},{S_},{N_})", inputs(B_, S_, H_, N_, torch.bfloat16),
              TOL["bfloat16"], WKV6_TOL_F32)
    r, k, v, wlog, u, st = args
    n_elem = r.numel()  # (b, h, t, n)
    b_ms, b_by = bound(nbytes(r, k, v, wlog, u) + 2 * nbytes(st) + nbytes(r),
                       4 * n_elem * N, "float32")
    return dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6.py:73",
        shape=f"r/k/v ({BATCH},{H},{PROMPT},{N}) bf16, wlog/u/state f32", max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: rwkv6.wkv6(*args), lambda: rwkv6.wkv6_ref(*args)),
    )


def rglru_row(randn, dev):
    """rglru at recurrentgemma-9b's prefill shape (batch 4, prompt 2048, lru
    4096) with float32 and with bf16 log_a/m, each timed beside its bound;
    then the reference's test shapes and the edge cases of the kernel's
    ring (S = 1, a short last tile, partial slabs, rows that are not
    16-byte aligned, a long sequence on two slabs, no decay and full
    decay), each against the plain version within the float32 tolerance.
    No single PyTorch call computes the recurrence."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rglru as lru

    print("kernel rglru")
    W = get_arch("recurrentgemma-9b").lru_width
    f32, bf = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(B_, S_, W_, dtype=f32):
        """tests/test_kernels.py's distributions; log_a and m in ``dtype``."""
        return ((-torch.exp(0.5 * randn(B_, S_, W_, dtype=f32))).to(dtype),
                randn(B_, S_, W_, dtype=dtype), randn(B_, W_, dtype=f32))

    def check(name, args):
        log_a, m, _ = lru.kernel_inputs(*args)  # as the wrapper passes them on
        vec = lru.copy_bytes(log_a.shape[-1], log_a.element_size(), log_a.data_ptr(),
                             m.data_ptr())
        name = f"rglru {'bf16' if log_a.dtype == bf else 'f32'} {name}, {vec}-byte copies"
        (h_seq, h_final), (r_seq, r_final) = lru.rglru(*args), lru.rglru_ref(*args)
        return max(compare(f"{name} h_seq", h_seq, r_seq, TOL["float32"]),
                   compare(f"{name} h_final", h_final, r_final, TOL["float32"]))

    rows = []
    for dtype in (f32, bf):
        blocks, per_sm = BATCH * -(-W // lru.SLAB), lru.blocks_per_sm(dtype, 16)
        print(f"  rglru grid at ({BATCH},2048,{W}) {dtype}: {blocks} blocks, {per_sm} resident "
              f"per SM x {sms} SMs = {per_sm * sms}")
        if blocks > per_sm * sms:
            fail(f"rglru {dtype}: {blocks} blocks do not fit one wave ({per_sm} per SM)")
        args = inputs(BATCH, 2048, W, dtype)
        err = check(f"({BATCH},2048,{W})", args)
        log_a, m, h0 = args
        b_ms, b_by = bound(nbytes(log_a, m, h0) + 4 * log_a.numel() + nbytes(h0),
                           3 * log_a.numel(), "float32")
        tag = "f32" if dtype == f32 else "bf16"
        rows.append(dict(
            name="rglru", route="cuda", source="src/repro_torch/csrc/rglru.cu",
            replaces="src/repro/kernels/rglru.py:46",
            shape=f"log_a/m ({BATCH},2048,{W}) {tag}, h0 f32", max_abs_err=err,
            bound_ms=b_ms, bound_by=b_by,
            **timings(lambda: lru.rglru(*args), lambda: lru.rglru_ref(*args)),
        ))
        del args, log_a, m, h0
    for dtype in (f32, bf):
        for shape in ((1, 64, 32), (2, 128, 64), (2, 192, 128),  # tests/test_kernels.py
                      (2, 300, 96), (2, 1, 64), (2, 200, 48)):  # ragged, S = 1, short tile
            check(f"{shape}", inputs(*shape, dtype))
        for W_ in (98, 99, 100):  # rows not 16-byte aligned; bf16 99: odd rows
            check(f"unaligned rows (2,130,{W_})", inputs(2, 130, W_, dtype))
        flat = randn(2 * 130 * 64 + 1, dtype=dtype)  # bases one element off alignment
        log_a, m, h0 = inputs(2, 130, 64, dtype)
        log_a = flat[1:].copy_(log_a.flatten()).view(2, 130, 64)
        check("(2,130,64) on bases one element off", (log_a, m, h0))
        extreme = inputs(2, 256, 160, dtype)
        extreme[0][..., 0::3] = -30.0  # decay to 0 in one step
        extreme[0][..., 1::3] = 0.0  # no decay: h sums m
        check("log_a -30 and 0 (2,256,160)", extreme)
    check("long (1,16384,64) on two slabs", inputs(1, 16384, 64))
    return rows


def plain_replay(model, params, prompt, tokens, n_steps: int):
    """The same weights through the plain versions on the card, fed the
    kernel run's greedy tokens: logits of the prefill and n_steps decodes."""
    import torch

    from repro_torch.kernels import ops

    S = prompt.shape[1]
    with torch.inference_mode(), ops.plain_versions():
        ref, caches = model.prefill(params, prompt, cache_len=S + NEW)
        steps = [ref]
        for i in range(n_steps):
            ref, caches = model.decode(params, tokens[:, i:i + 1], S + i, caches)
            steps.append(ref)
    return steps


def want_launches(model) -> dict:
    """The exact launches of one prefill and NEW - 1 decode steps: two norms
    per layer and the final one per forward; per attention layer one
    flash_attention in the prefill and one flash_decode per step; one wkv6
    per rwkv layer and one rglru per rec layer, in the prefill only (their
    decode steps are plain torch, as in the reference)."""
    kinds = model.kinds
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    return {"rmsnorm": (2 * len(kinds) + 1) * NEW, "flash_attention": n_attn,
            "flash_decode": n_attn * (NEW - 1), "wkv6": kinds.count("rwkv"),
            "rglru": kinds.count("rec")}


def serve_phase(arch: str, prompt_len: int, card: str) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    model, params, prompt = serve.setup(arch, full=True, batch=BATCH, prompt_len=prompt_len,
                                        device="cuda", seed=0)
    cfg = model.cfg
    serve.generate(model, params, prompt, 3)  # warm-up (cuBLAS, allocator)

    ops.reset_launch_counts()
    gen = serve.generate(model, params, prompt, NEW)
    counts = ops.launch_counts()
    want = want_launches(model)
    print(f"serve {arch} launches {counts} (want {want})")
    if counts != want:
        fail(f"{arch}: kernel launch counts {counts} != {want}")
    logits = torch.stack(gen.logits)
    if logits.shape != (NEW, BATCH, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"{arch} serve logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")

    steps = plain_replay(model, params, prompt, gen.tokens, 4)
    for i, ref in enumerate(steps):
        got_tok = gen.tokens[:, i]
        ref_f = ref.float()
        top = ref_f.max(dim=-1).values
        at_tok = ref_f.gather(1, got_tok[:, None])[:, 0]
        exact = int((ref_f.argmax(dim=-1) == got_tok).sum())
        diff = float((gen.logits[i].float() - ref_f).abs().max())
        gap = float((top - at_tok).max())
        print(f"  step {i}: tokens equal {exact}/{BATCH}, max |logits kernel - plain| {diff:.4g}, "
              f"largest plain-logit gap to the kernel's token {gap:.4g}")
        if gap > TOKEN_TIE_TOL[arch]:
            fail(f"{arch} step {i}: greedy token {got_tok.tolist()} vs plain "
                 f"{ref_f.argmax(dim=-1).tolist()} beyond a near-tie ({gap:.4g} > "
                 f"{TOKEN_TIE_TOL[arch]})")
        if diff > BF16_LOGITS_DRIFT[arch]:
            fail(f"{arch} step {i}: max |logits kernel - plain| {diff:.4g} > "
                 f"{BF16_LOGITS_DRIFT[arch]}")

    res = serve.summary(arch, gen)
    print(f"serve {arch} full width, batch {BATCH}, prompt {prompt_len}, {NEW} new tokens on "
          f"{card}: prefill_s {res['prefill_s']} decode_p50_s {res['decode_p50_s']} "
          f"decode_p99_s {res['decode_p99_s']} tokens_per_s {res['tokens_per_s']}")
    print(json.dumps({"serve": res, "prompt": prompt_len, "launches": counts, "card": card}))
    profile_serve(model, params, prompt, res)
    del model, params, gen, logits, steps
    torch.cuda.empty_cache()
    return counts


def profile_serve(model, params, prompt, res) -> None:
    """Where a prefill and a decode step spend their time: device time per
    step (torch.profiler), its share of the unprofiled wall time of the
    serve run (prefill_s, decode_p50_s), and the kernels with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    B, S = prompt.shape
    with torch.inference_mode():
        _, caches = model.prefill(params, prompt, cache_len=S + NEW)
        tok = prompt[:, -1:]

        def prefill():
            model.prefill(params, prompt, cache_len=S + NEW)

        def decode_steps(n=8):
            for i in range(n):
                model.decode(params, tok, S + i, caches)

        for name, fn, n_steps, unprofiled_s in (("prefill", prefill, 1, res["prefill_s"]),
                                                ("decode", decode_steps, 8, res["decode_p50_s"])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0_s = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0_s
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            device_us = sum(e.self_device_time_total for e in events)
            if device_us <= 0:
                print(f"profile {name}: no device time in the trace (not measured)")
                continue
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
            busy_s = device_us / 1e6 / n_steps
            print(f"profile {name} ({n_steps} step(s)): device busy {busy_s * 1e3:.3f} ms/step = "
                  f"{100 * busy_s / unprofiled_s:.1f}% of the unprofiled {unprofiled_s * 1e3:.3f} "
                  f"ms (profiled wall {wall_s * 1e3 / n_steps:.3f} ms/step)")
            for e in top:
                print(f"    {e.self_device_time_total / 1e3 / n_steps:9.3f} ms/step "
                      f"{e.count // n_steps:5d}x/step  {e.key[:90]}")


def full_width_f32_phase(dev, arch: str, prompt_len: int):
    """A model at full width in float32: the kernel path against the plain
    path on the same weights. Every kernel is exact to ~1e-6 in float32, so
    the two must give the same greedy tokens and logits within 1e-3."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = model.init(g, dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, prompt_len), generator=g, device=dev,
                           dtype=torch.int64)
    gen = serve.generate(model, params, prompt, 5)
    steps = plain_replay(model, params, prompt, gen.tokens, 4)
    worst = 0.0
    for i, ref in enumerate(steps):
        worst = max(worst, float((gen.logits[i] - ref).abs().max()))
        if not torch.equal(gen.tokens[:, i], ref.argmax(dim=-1)):
            fail(f"full-width f32 {arch} step {i}: tokens {gen.tokens[:, i].tolist()} vs plain "
                 f"{ref.argmax(dim=-1).tolist()}")
    if not worst <= LOGITS_TOL_FULL_F32:
        fail(f"full-width f32 {arch}: max |logits kernel - plain| {worst:.3g} > "
             f"{LOGITS_TOL_FULL_F32}")
    print(f"full-width f32 {arch}: kernel path == plain path, tokens equal over 5 steps, "
          f"max |logits diff| {worst:.3g} (tol {LOGITS_TOL_FULL_F32})")
    del model, params, gen, steps
    torch.cuda.empty_cache()


def reduced_reference_phase(dev):
    """A reduced float32 model of each family on the card (kernels) against
    the same weights on the CPU (plain versions): gemma, rwkv6, and
    recurrentgemma with 5 layers (its pattern group plus the remainder
    stack) and a prompt of three windows."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu()

    for arch, n_layers, prompt_len in (("gemma-2b", 2, 40), ("rwkv6-1.6b", 2, 40),
                                       ("recurrentgemma-9b", 5, 48)):
        cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=n_layers)
        model = build_model(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        params = model.init(g, dev)
        prompt = torch.randint(0, cfg.vocab, (2, prompt_len), generator=g, device=dev,
                               dtype=torch.int64)
        got = serve.generate(model, params, prompt, 6)
        want = serve.generate(model, to_cpu(params), prompt.cpu(), 6)
        for i, (a, b) in enumerate(zip(got.logits, want.logits)):
            err = float((a.cpu() - b).abs().max())
            if not err <= LOGITS_TOL_F32:
                fail(f"reduced f32 {arch}, step {i}: max |card - cpu| {err:.3g} > "
                     f"{LOGITS_TOL_F32}")
        if not torch.equal(got.tokens.cpu(), want.tokens):
            fail(f"reduced f32 {arch}: greedy tokens differ between card and CPU")
        print(f"reduced f32 {arch} ({n_layers} layers {model.kinds}): card kernels == CPU "
              f"plain versions within {LOGITS_TOL_F32}, tokens equal")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/csrc beside {Path(__file__).name}: run it from the repository")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0_s = time.perf_counter()
    _build.lib()  # compiles the sources on first use, then loads the library
    build_s = time.perf_counter() - t0_s
    print(f"build: {build_s:.1f} s -> {_build.library_path().relative_to(ROOT)}")
    ptxas_report(_build.library_path(), "flash_tc_kernel")
    ptxas_report(_build.library_path(), "decode_kernel")
    ptxas_report(_build.library_path(), "rglru_kernel")
    ptxas_report(_build.library_path(), "wkv6_kernel")
    sass_check(_build.library_path())

    rows = kernel_phase(dev)
    launches = {r["name"]: 0 for r in rows}  # summed over the serve runs
    for arch, prompt_len in SERVES:
        for name, n in serve_phase(arch, prompt_len, card).items():
            launches[name] += n
    for arch, prompt_len in SERVES:
        full_width_f32_phase(dev, arch, prompt_len)
    reduced_reference_phase(dev)

    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] == 0:
            fail(f"{r['name']}: no launch on any serve path")
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
