"""The float32 route of the flash-attention backward (``csrc/flash_attention_bwd.cu``,
``flash_bwd_f32_kernel``: its dK/dV blocks and its dQ blocks), emulated in
float32 torch and held against ``jax.vjp`` of the reference attention and
against the port's plain version on the same numpy inputs.

The emulation follows the kernels' tiles and arithmetic:
- dK/dV: blocks of 64 keys, four warps of 16 keys, query tiles of 32 rows
  (16 at hd 256) from each warp's first visible tile to its last; dQ:
  blocks of 64 rows, four warps of 16 rows, each with two halves of 16 keys
  of every 32-key tile, the halves added once at the end, half 0 first;
- the same tile ranges and the same test of which tiles need the
  element mask (a tile judged unmasked is computed without it);
- every operand of every product split into TF32 parts, hi = tf32(x) and
  lo = tf32(x - hi) (``tests/test_torch_flash_f32.py``'s rounding), the
  score-shaped products as hi·hi + (hi·lo + lo·hi), the accumulating ones
  as hi·hi, hi·lo, lo·hi for each k-step of 8 in order;
- P = exp2(s·scale·log2e − lse·log2e) from the forward's natural-log lse,
  D = rowsum(dO ∘ O), dS = P ∘ (dP − D);
- per-head dK/dV partials summed over a group in head order.
A matrix product inside the emulation sums in torch's order, not the
tensor cores': the emulation checks the roundings and the tiling, and on
the card ``chip_smoke.py`` holds the kernels themselves against
``flash_attention_bwd_ref``. A cross-attention (Sk keys for S queries, not
causal: dK/dV blocks over the Sk keys, dQ blocks over the S queries) is
held against ``jax.vjp`` of the reference's ``_sdpa``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from test_torch_flash_bwd import jax_cross_vjp
from test_torch_flash_f32 import split, tf32

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

KEYS = 64  # dK/dV: keys a block, four warps of 16
ROWS = 64  # dQ: query rows a block, four warps of 16
KEY_TILE = 32  # dQ: keys a K/V tile, two halves of 16
K_STEP = 8  # keys or queries a k-step of the accumulating products
LOG2E = 1.4426950408889634
BWD_TOL = (1e-4, 1e-4)  # chip_smoke.BWD_TOL["float32"]: (atol, rtol)


def query_tile(hd):
    """dK/dV: query rows a streamed tile (two stages fit at hd 256 only at 16)."""
    return 16 if hd == 256 else 32


def dkdv_tiles(S, hd, causal, window, Sk=None):
    """The dK/dV kernel's work: (first key of a 16-key warp, first query of
    a tile, whether the tile needs the element mask), in the kernel's order;
    Sk keys (S unless given) for S queries."""
    Sk = Sk or S
    bq = query_tile(hd)
    n_qt = -(-S // bq)
    out = []
    for p0 in range(0, Sk, KEYS):
        p_last = min(p0 + KEYS, Sk) - 1
        t_lo = p0 // bq if causal else 0
        t_hi = min(n_qt, (p_last + window - 1) // bq + 1) if window > 0 else n_qt
        for w in range(4):
            kw0 = p0 + 16 * w
            if kw0 >= Sk:
                continue
            kw1 = min(kw0 + 15, Sk - 1)
            a_lo = max(t_lo, kw0 // bq if causal else 0)
            a_hi = min(t_hi, (kw1 + window - 1) // bq + 1 if window > 0 else n_qt)
            for t in range(a_lo, a_hi):
                c0 = t * bq
                masked = (c0 + bq > S or kw0 + 16 > Sk or (causal and kw0 + 15 > c0)
                          or (window > 0 and kw0 <= c0 + bq - 1 - window))
                out.append((kw0, c0, masked))
    return out


def dq_tiles(S, causal, window, Sk=None):
    """The dQ kernel's work: (first row of a 16-row warp, first key of its
    16-key half, the half, whether the pair of tiles needs the element
    mask); Sk keys (S unless given) for S queries."""
    Sk = Sk or S
    n_kt = -(-Sk // KEY_TILE)
    out = []
    for q0 in range(0, S, ROWS):
        q_last = min(q0 + ROWS, S) - 1
        kt_hi = min(n_kt, q_last // KEY_TILE + 1) if causal else n_kt
        kt_lo = max(0, q0 - window + 1) // KEY_TILE if window > 0 else 0
        for w in range(4):
            qw0 = q0 + 16 * w
            if qw0 >= S:
                continue
            qw1 = min(qw0 + 15, S - 1)
            for kt in range(kt_lo, kt_hi):
                for half in (0, 1):
                    kw0 = kt * KEY_TILE + 16 * half
                    active = (kw0 < Sk and (not causal or kw0 <= qw1)
                              and (window <= 0 or kw0 + 15 > qw0 - window))
                    if active:
                        masked = (kw0 + 16 > Sk or qw0 + 16 > S or (causal and kw0 + 15 > qw0)
                                  or (window > 0 and kw0 <= qw1 - window))
                        out.append((qw0, kw0, half, masked))
    return out


def _visible(qpos, kpos, S, causal, window, Sk=None):
    ok = (qpos < S) & (kpos < (Sk or S))
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def _score(a, b, parts):
    """a · bᵀ as the kernels take it: hi·hi + (hi·lo + lo·hi)."""
    (ah, al), (bh, bl) = parts(a), parts(b)
    s = ah @ bh.transpose(-1, -2)
    return s if al is None else s + (ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2))


def _accumulate(acc, p, b, parts):
    """acc + p · b in k-steps of 8, each as hi·hi, hi·lo, lo·hi in order."""
    for s0 in range(0, p.shape[-1], K_STEP):
        (ph, pl), (bh, bl) = parts(p[..., s0:s0 + K_STEP]), parts(b[..., s0:s0 + K_STEP, :])
        acc = acc + ph @ bh
        if pl is not None:
            acc = acc + ph @ bl
            acc = acc + pl @ bh
    return acc


def emulate(q, k, v, o, dout, lse, *, causal=True, window=0, three_passes=True):
    """The float32 route's arithmetic on float32 (B, H, S, hd) q, o, dout,
    (B, K, Sk, hd) k, v and (B, H, S) lse; returns (dq, dk, dv). With
    ``three_passes`` False every operand is rounded to TF32 once and every
    product is one pass."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    g = H // K
    # the wrapper passes the scale as a C float; the host folds in log2(e)
    scale = np.float32(1.0 / math.sqrt(hd))
    scale_log2 = float(np.float32(scale * np.float32(LOG2E)))
    scale = float(scale)

    def parts(x):
        return split(x) if three_passes else (tf32(x), None)

    # zero rows past S (Sk), as the copies land them; lse and D read as 0 there
    pad = -(-S // KEYS) * KEYS - S
    kpad = -(-Sk // KEYS) * KEYS - Sk
    qp, gp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, dout))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, kpad)) for t in (k, v))
    kk, vv = (torch.repeat_interleave(t, g, dim=1) for t in (kp, vp))
    D = torch.nn.functional.pad((dout * o).sum(dim=-1), (0, pad))
    l2 = torch.nn.functional.pad(lse * np.float32(LOG2E), (0, pad))

    def probs(s, lse2, qpos, kpos, masked):
        p = torch.exp2(s * scale_log2 - lse2)
        if masked:
            p = torch.where(_visible(qpos, kpos, S, causal, window, Sk), p, torch.zeros(()))
        return p

    # dK/dV: rows are keys, columns queries
    bq = query_tile(hd)
    dv_part = torch.zeros((B, H, Sk + kpad, hd))
    dk_part = torch.zeros((B, H, Sk + kpad, hd))
    acc = {}
    for kw0, c0, masked in dkdv_tiles(S, hd, causal, window, Sk):
        keys, qs = slice(kw0, kw0 + 16), slice(c0, c0 + bq)
        kpos = torch.arange(kw0, kw0 + 16)[:, None]
        qpos = torch.arange(c0, c0 + bq)[None, :]
        pt = probs(_score(kk[:, :, keys], qp[:, :, qs], parts), l2[:, :, None, qs], qpos, kpos,
                   masked)
        dst = pt * (_score(vv[:, :, keys], gp[:, :, qs], parts) - D[:, :, None, qs])
        av, ak = acc.get(kw0, (torch.zeros((B, H, 16, hd)), torch.zeros((B, H, 16, hd))))
        acc[kw0] = (_accumulate(av, pt, gp[:, :, qs], parts),
                    _accumulate(ak, dst, qp[:, :, qs], parts))
    for kw0, (av, ak) in acc.items():
        dv_part[:, :, kw0:kw0 + 16] = av
        dk_part[:, :, kw0:kw0 + 16] = ak * scale
    dk, dv = (group_sum(t[:, :, :Sk], K) for t in (dk_part, dv_part))

    # dQ: rows are queries, columns keys; two halves of the keys apart
    halves = {}
    for qw0, kw0, half, masked in dq_tiles(S, causal, window, Sk):
        rows, keys = slice(qw0, qw0 + 16), slice(kw0, kw0 + 16)
        qpos = torch.arange(qw0, qw0 + 16)[:, None]
        kpos = torch.arange(kw0, kw0 + 16)[None, :]
        dp = _score(gp[:, :, rows], vv[:, :, keys], parts)
        p = probs(_score(qp[:, :, rows], kk[:, :, keys], parts), l2[:, :, rows, None], qpos,
                  kpos, masked)
        ds = p * (dp - D[:, :, rows, None])
        a = halves.get((qw0, half), torch.zeros((B, H, 16, hd)))
        halves[(qw0, half)] = _accumulate(a, ds, kk[:, :, keys], parts)
    dq = torch.zeros((B, H, S + pad, hd))
    for qw0 in range(0, S, 16):
        zero = torch.zeros((B, H, 16, hd))
        dq[:, :, qw0:qw0 + 16] = (halves.get((qw0, 0), zero) + halves.get((qw0, 1), zero)) * scale
    return dq[:, :, :S], dk, dv


def group_sum(part, K):
    """The second pass: each KV head's partials summed in head order, head 0
    first."""
    B, H, S, hd = part.shape
    grouped = part.reshape(B, K, H // K, S, hd)
    acc = grouped[:, :, 0].clone()
    for hh in range(1, H // K):
        acc = acc + grouped[:, :, hh]
    return acc


def _inputs(rng, B, H, K, S, hd, Sk=None):
    Sk = Sk or S
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, K, Sk, hd), (B, K, Sk, hd), (B, H, S, hd))]


CASES = {  # B, H, K, S, hd, causal, window
    "causal_gqa_g2_hd64": (1, 4, 2, 128, 64, True, 0),
    "window48_gqa_g2_hd64": (1, 4, 2, 160, 64, True, 48),
    "not_causal_hd32": (1, 2, 2, 100, 32, False, 0),
    "ragged_s77_mqa_hd128": (2, 2, 1, 77, 128, True, 0),
    "causal_mqa_g4_hd256": (1, 4, 1, 96, 256, True, 0),
    "ragged_s70_hd16": (1, 2, 2, 70, 16, True, 0),
    "not_causal_window40_hd256": (1, 2, 2, 90, 256, False, 40),
    "ragged_s100_mha_hd96": (1, 2, 2, 100, 96, True, 0),
    "window40_gqa_g2_hd96": (1, 4, 2, 90, 96, True, 40),
}


def _forward(q, k, v, causal, window):
    """The forward's float32 output and lse (the backward's inputs)."""
    return fa.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)


def _within(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, dtype=np.float32)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_TOL[0], rtol=BWD_TOL[1],
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_within_float32_tolerance_of_jax_vjp(case):
    B, H, K, S, hd, causal, window = CASES[case]
    q, k, v, dout = _inputs(np.random.default_rng(S + 31 * H + hd + window), B, H, K, S, hd)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse = _forward(qt, kt, vt, causal, window)
    got = emulate(qt, kt, vt, o, gt, lse, causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _within(got, vjp(jnp.asarray(dout)), case)


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_within_float32_tolerance_of_plain_version(case):
    """The comparison chip_smoke.py makes with the kernels on the card."""
    B, H, K, S, hd, causal, window = CASES[case]
    qt, kt, vt, gt = (torch.from_numpy(a) for a in _inputs(
        np.random.default_rng(S + 31 * H + hd + window + 1), B, H, K, S, hd))
    o, lse = _forward(qt, kt, vt, causal, window)
    got = emulate(qt, kt, vt, o, gt, lse, causal=causal, window=window)
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse, causal=causal, window=window)
    _within(got, [w.numpy() for w in want], case)


CROSS_CASES = {  # B, H, K, S, Sk, hd: Sk keys for S queries, not causal
    "sk1500_s40_mha_hd64": (1, 2, 2, 40, 1500, 64),
    "sk65_s100_g2_hd64": (1, 4, 2, 100, 65, 64),
    "sk1_s40_g2_hd32": (2, 4, 2, 40, 1, 32),
    "sk63_s100_mha_hd96": (1, 2, 2, 100, 63, 96),
    "sk130_s70_g2_hd256": (1, 4, 2, 70, 130, 256),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_emulation_key_length_within_float32_tolerance_of_jax_vjp(case):
    """A cross-attention's backward against ``jax.vjp`` of the reference's
    ``_sdpa``, which its cross-attention runs."""
    B, H, K, S, Sk, hd = CROSS_CASES[case]
    q, k, v, dout = _inputs(np.random.default_rng(S + 7 * Sk + hd), B, H, K, S, hd, Sk)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse = _forward(qt, kt, vt, False, 0)
    got = emulate(qt, kt, vt, o, gt, lse, causal=False)
    _within(got, jax_cross_vjp(q, k, v, dout)[1], case)


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_emulation_key_length_within_float32_tolerance_of_plain_version(case):
    """The comparison chip_smoke.py makes with the kernels on the card."""
    B, H, K, S, Sk, hd = CROSS_CASES[case]
    qt, kt, vt, gt = (torch.from_numpy(a) for a in _inputs(
        np.random.default_rng(S + 7 * Sk + hd + 1), B, H, K, S, hd, Sk))
    o, lse = _forward(qt, kt, vt, False, 0)
    got = emulate(qt, kt, vt, o, gt, lse, causal=False)
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse, causal=False)
    _within(got, [w.numpy() for w in want], case)


def test_one_tf32_rounding_breaks_the_float32_tolerance():
    """Why every operand is split: with one TF32 rounding and one pass per
    product, gemma-2b's head dim (256, MQA g 4, S cut to 96) leaves the
    card's float32 tolerance against the plain version by far; the split
    keeps inside it."""
    B, H, K, S, hd = 1, 4, 1, 96, 256
    qt, kt, vt, gt = (torch.from_numpy(a) for a in
                      _inputs(np.random.default_rng(256), B, H, K, S, hd))
    o, lse = _forward(qt, kt, vt, True, 0)
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse)
    atol, rtol = BWD_TOL

    def worst(three_passes):
        got = emulate(qt, kt, vt, o, gt, lse, three_passes=three_passes)
        return max(float(((a - w).abs() - rtol * w.abs()).max()) for a, w in zip(got, want))

    split_worst, one_worst = worst(True), worst(False)
    assert split_worst <= atol < one_worst
    assert one_worst > 10 * atol


SHAPES = [(S, hd, causal, window) for S in (1, 16, 77, 130) for hd in (64, 96, 256)
          for causal, window in ((True, 0), (False, 0), (True, 40), (False, 24))]


@pytest.mark.parametrize("S,hd,causal,window", SHAPES)
def test_tiles_cover_every_visible_pair_and_mask_where_needed(S, hd, causal, window):
    """Each kernel computes every visible (query, key) pair exactly once, in
    a tile it loads, and a tile it takes as unmasked holds only visible
    pairs: tiles above the causal diagonal and before the window are
    skipped, and only diagonal, window-edge and ragged tiles are masked."""
    _check_tiles(S, S, hd, causal, window)


# a cross-attention's (S queries, Sk keys), not causal: fewer and more keys
# than queries, ragged on either side
CROSS_SHAPES = [(S, Sk, hd) for S, Sk in ((40, 1), (40, 65), (100, 63), (16, 1500), (77, 130))
                for hd in (64, 256)]


@pytest.mark.parametrize("S,Sk,hd", CROSS_SHAPES)
def test_tiles_cover_every_visible_pair_of_a_cross_attention(S, Sk, hd):
    """The same with Sk != S: the dK/dV blocks over the Sk keys and the dQ
    blocks over the S queries see every (query, key) pair once, and only
    tiles ragged on either side are masked."""
    _check_tiles(S, Sk, hd, False, 0)


def _check_tiles(S, Sk, hd, causal, window):
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Sk)[None, :]
    visible = _visible(qpos, kpos, S, causal, window, Sk)
    bq = query_tile(hd)
    for tiles, cover in (
            ([(c0, bq, kw0, 16, m) for kw0, c0, m in dkdv_tiles(S, hd, causal, window, Sk)],
             "dK/dV"),
            ([(qw0, 16, kw0, 16, m) for qw0, kw0, _, m in dq_tiles(S, causal, window, Sk)], "dQ")):
        seen = torch.zeros((S, Sk), dtype=torch.int32)
        for r0, nr, c0, nc, masked in tiles:
            block = torch.zeros((S + 64, Sk + 64), dtype=torch.bool)
            block[r0:r0 + nr, c0:c0 + nc] = True
            block = block[:S, :Sk]
            if not masked:
                assert r0 + nr <= S and c0 + nc <= Sk, cover
                assert bool(visible[block].all()), f"{cover}: an unmasked tile holds a hidden pair"
            seen += (block & visible).int()
        assert torch.equal(seen, visible.int()), f"{cover}: a visible pair is missed or repeated"


def test_cpu_launches_no_float32_route():
    """On the CPU the autograd Function runs the plain versions: the float32
    routes' counters stay at 0, as do the kernels' own."""
    ops.reset_launch_counts()
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    ops.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None
    assert ops.f32_launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert all(n == 0 for n in ops.launch_counts().values())
