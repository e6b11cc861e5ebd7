"""The bf16 tensor-core route of the flash-attention backward
(``csrc/flash_attention_bwd.cu``, ``flash_bwd_tc_kernel``), emulated in
float32 torch and held against ``jax.vjp`` of the reference attention on the
same numpy inputs.

The emulation follows the kernel's arithmetic: 64-key and 64-query tiles;
P = exp2(s·scale·log2e − lse·log2e) from the forward's natural-log lse;
D = rowsum(dO ∘ O) in float32; P and dS = P ∘ (dP − D)
enter the products as a bf16 high part plus the bf16 rounding of the rest
(one bf16 rounding alone breaks the bf16 tolerance of the card's check);
float32 accumulation tile by tile; per-head float32 dK/dV partials summed
over the group in head order; outputs rounded to bf16. On the card
``chip_smoke.py`` holds the kernel itself against ``flash_attention_bwd_ref``.
A cross-attention's shapes (Sk keys for S queries, not causal) are held
against ``jax.vjp`` of the reference's ``_sdpa``, which its cross-attention
runs.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

TILE = 64
LOG2E = math.log2(math.e)
# chip_smoke.BWD_TOL["bfloat16"]: (atol, rtol) of a bf16 gradient
BWD_TOL = (1e-3, 2.0 ** -7)


def _split_bf16(x):
    """x as the kernel feeds it to the tensor cores: its bf16 high part plus
    the bf16 rounding of the remainder, both back in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tiled(a, b, axis_len):
    """sum over 64-wide tiles of a[..., tile] @ b[..., tile, :], in tile order."""
    acc = None
    for t0 in range(0, axis_len, TILE):
        part = a[..., t0:t0 + TILE] @ b[..., t0:t0 + TILE, :]
        acc = part if acc is None else acc + part
    return acc


def _tensor_core_bwd_emulation(q, k, v, o, dout, lse, causal, window):
    """Returns (dq, dk, dv) in bf16 and the per-head float32 dK/dV partials.
    q, o, dout: (B, H, S, hd) bf16; k/v: (B, K, Sk, hd) bf16; lse (B, H, S).
    dQ runs over the Sk keys in key tiles, dK/dV over the S queries in
    query tiles."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    qf, gf, of = q.float(), dout.float(), o.float()
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    D = (gf * of).sum(dim=-1)
    mask = fa._mask(S, causal, window, q.device, Sk)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    x = s * torch.tensor(scale * LOG2E) - (lse * torch.tensor(LOG2E))[..., None]
    p = torch.where(mask, torch.exp2(x), torch.zeros(()))
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - D[..., None])
    p_hi, p_lo = _split_bf16(p)
    ds_hi, ds_lo = _split_bf16(ds)
    # dQ block: key tiles in order, the high part's product then the low's
    dq = _tiled(ds_hi, kf, Sk) + _tiled(ds_lo, kf, Sk)
    # dK/dV block of one head: query tiles in order
    pt_hi, pt_lo, dst_hi, dst_lo = (t.transpose(-1, -2) for t in (p_hi, p_lo, ds_hi, ds_lo))
    dv_part = _tiled(pt_hi, gf, S) + _tiled(pt_lo, gf, S)
    dk_part = (_tiled(dst_hi, qf, S) + _tiled(dst_lo, qf, S)) * scale
    return ((dq * scale).to(torch.bfloat16), _group_sum(dk_part, K).to(torch.bfloat16),
            _group_sum(dv_part, K).to(torch.bfloat16), dk_part, dv_part)


def _group_sum(part, K):
    """The second pass: each KV head's g partials summed in head order,
    head 0 first. part: (B, H, S, hd) float32."""
    B, H, S, hd = part.shape
    grouped = part.reshape(B, K, H // K, S, hd)
    acc = grouped[:, :, 0].clone()
    for hh in range(1, H // K):
        acc = acc + grouped[:, :, hh]
    return acc


def _bf16_inputs(rng, B, H, K, S, hd, Sk=None):
    """q, k, v, dout as float32 numpy holding bf16 values (k and v of Sk
    keys, S unless given)."""
    Sk = Sk or S
    out = []
    for shape in ((B, H, S, hd), (B, K, Sk, hd), (B, K, Sk, hd), (B, H, S, hd)):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append(torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    return out


CASES = {  # B, H, K, S, hd, causal, window
    "causal_mqa_g8_hd256": (1, 8, 1, 256, 256, True, 0),
    "window_mqa_g16_hd256": (1, 16, 1, 192, 256, True, 128),
    "causal_gqa_g2_hd64": (2, 4, 2, 128, 64, True, 0),
    "ragged_s300_g8_hd64": (1, 8, 1, 300, 64, True, 0),
    "not_causal_g1_hd64": (1, 2, 2, 160, 64, False, 0),
    "window_gqa_g2_hd64": (1, 4, 2, 200, 64, True, 80),
    "ragged_s200_mha_hd96": (1, 4, 4, 200, 96, True, 0),
}


def _within(got, want, what):
    atol, rtol = BWD_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, dtype=np.float32),
                                   atol=atol, rtol=rtol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_bwd_within_bf16_tolerance_of_jax_vjp(case):
    """Against the reference's exact gradient. D here is formed from the
    forward's float32 output: from its bf16 output (what the kernel reads)
    D moves by ~dO·O's rounding, which puts the float32 plain version just
    as far (up to ~5e-3 past rtol) from jax.vjp; the next test covers that
    input."""
    B, H, K, S, hd, causal, window = CASES[case]
    rng = np.random.default_rng(S + 31 * H + hd + window)
    q, k, v, dout = _bf16_inputs(rng, B, H, K, S, hd)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dout))
    o32, lse = fa.flash_attention_ref(qt.float(), kt.float(), vt.float(), causal=causal,
                                      window=window, return_lse=True)
    got = _tensor_core_bwd_emulation(qt, kt, vt, o32, gt, lse, causal, window)[:3]
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _within(got, vjp(jnp.asarray(dout)), case)


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_bwd_within_bf16_tolerance_of_plain_version(case):
    """Against the port's plain version on the same bf16 forward output and
    lse: the comparison chip_smoke.py makes with the kernel on the card."""
    B, H, K, S, hd, causal, window = CASES[case]
    rng = np.random.default_rng(S + 31 * H + hd + window + 1)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in _bf16_inputs(rng, B, H, K, S, hd))
    o, lse = fa.flash_attention_ref(qt, kt, vt, causal=causal, window=window, return_lse=True)
    got = _tensor_core_bwd_emulation(qt, kt, vt, o, gt, lse, causal, window)[:3]
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse, causal=causal, window=window)
    _within(got, [w.float().numpy() for w in want], case)


def jax_cross_vjp(q, k, v, dout):
    """The reference's cross-attention (``_sdpa``: every key valid, not
    causal) on numpy q (B, H, S, hd) and k / v (B, K, Sk, hd), and its vjp
    at ``dout``: (out, [dq, dk, dv]) in the same layout, numpy."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    qpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    kpos = jnp.broadcast_to(jnp.arange(Sk, dtype=jnp.int32), (B, Sk))

    def attend(a, b, c):
        a = a.transpose(0, 2, 1, 3).reshape(B, S, K, H // K, hd)
        out = JL._sdpa(a, b.transpose(0, 2, 1, 3), c.transpose(0, 2, 1, 3), qpos, kpos,
                       jnp.ones((B, Sk), bool), 0, False)
        return out.reshape(B, S, H, hd).transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(attend, *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(dout))]


CROSS_CASES = {  # B, H, K, S, Sk, hd: Sk keys for S queries, not causal
    "sk1500_s100_mha_hd64": (1, 2, 2, 100, 1500, 64),
    "sk65_s40_g2_hd64": (2, 4, 2, 40, 65, 64),
    "sk1_s40_g2_hd64": (1, 4, 2, 40, 1, 64),
    "sk63_s100_g1_hd96": (1, 2, 2, 100, 63, 96),
    "sk130_s64_g2_hd256": (1, 4, 2, 64, 130, 256),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_tensor_core_bwd_key_length_within_bf16_tolerance_of_jax_vjp(case):
    """A cross-attention's backward (dQ over Sk keys, dK / dV of Sk rows
    over S queries) against ``jax.vjp`` of the reference's ``_sdpa``, D
    from the forward's float32 output as above."""
    B, H, K, S, Sk, hd = CROSS_CASES[case]
    rng = np.random.default_rng(S + 7 * Sk + hd)
    q, k, v, dout = _bf16_inputs(rng, B, H, K, S, hd, Sk)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dout))
    o32, lse = fa.flash_attention_ref(qt.float(), kt.float(), vt.float(), causal=False,
                                      return_lse=True)
    got = _tensor_core_bwd_emulation(qt, kt, vt, o32, gt, lse, False, 0)[:3]
    _within(got, jax_cross_vjp(q, k, v, dout)[1], case)


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_tensor_core_bwd_key_length_within_bf16_tolerance_of_plain_version(case):
    """The same shapes against the port's plain version on the same bf16
    forward output and lse: the comparison chip_smoke.py makes with the
    kernel on the card."""
    B, H, K, S, Sk, hd = CROSS_CASES[case]
    rng = np.random.default_rng(S + 7 * Sk + hd + 1)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in _bf16_inputs(rng, B, H, K, S, hd, Sk))
    o, lse = fa.flash_attention_ref(qt, kt, vt, causal=False, return_lse=True)
    got = _tensor_core_bwd_emulation(qt, kt, vt, o, gt, lse, False, 0)[:3]
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse, causal=False)
    assert tuple(want[1].shape) == (B, K, Sk, hd)
    _within(got, [w.float().numpy() for w in want], case)


def test_one_bf16_rounding_of_p_and_ds_breaks_the_tolerance():
    """Why the kernel splits P and dS into two bf16 parts: with one rounding
    each, gemma-2b's MQA shape (cut to S 256) leaves the card's bf16
    tolerance against the float32 plain version."""
    B, H, K, S, hd = 1, 8, 1, 256, 256
    rng = np.random.default_rng(7)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in _bf16_inputs(rng, B, H, K, S, hd))
    o, lse = fa.flash_attention_ref(qt, kt, vt, return_lse=True)
    want = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse)
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, gf = qt.float(), kt.float().expand(B, H, S, hd), vt.float().expand(B, H, S, hd), \
        gt.float()
    p = torch.where(fa._mask(S, True, 0, "cpu"),
                    torch.exp2((qf @ kf.transpose(-1, -2)) * (scale * LOG2E)
                               - (lse * LOG2E)[..., None]), torch.zeros(()))
    ds = p * (gf @ vf.transpose(-1, -2) - (gf * o.float()).sum(-1, keepdim=True))
    one = ds.to(torch.bfloat16).float()
    dq_one = (one @ kf * scale).to(torch.bfloat16)
    dq_two = _tensor_core_bwd_emulation(qt, kt, vt, o, gt, lse, True, 0)[0]
    atol, rtol = BWD_TOL

    def worst(got):
        err = (got.float() - want[0].float()).abs()
        return float((err - rtol * want[0].float().abs()).max())

    assert worst(dq_two) <= atol < worst(dq_one)


def test_group_sum_is_head_ordered_and_repeatable():
    """The second pass sums a group's partials in head order: the same
    partials give the same bits every time, and the result is the plain
    left-to-right sum."""
    B, H, K, S, hd = 1, 16, 1, 192, 256
    rng = np.random.default_rng(16)
    qt, kt, vt, gt = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in _bf16_inputs(rng, B, H, K, S, hd))
    o, lse = fa.flash_attention_ref(qt, kt, vt, window=128, return_lse=True)
    _, dk, dv, dk_part, dv_part = _tensor_core_bwd_emulation(qt, kt, vt, o, gt, lse, True, 128)
    for total, part in ((dk, dk_part), (dv, dv_part)):
        again = _group_sum(part.clone(), K)
        assert torch.equal(_group_sum(part, K), again)
        assert torch.equal(again.to(torch.bfloat16), total)
        left = part[:, 0]
        for hh in range(1, H):
            left = left + part[:, hh]
        assert torch.equal(left[:, None], again)


@pytest.mark.parametrize("offset,transpose,want", [
    (0, False, True),    # contiguous (B, H, S, hd)
    (0, True, True),     # a (B, S, H, hd) buffer read as (B, H, S, hd)
    (1, False, False),   # base one element off 16 bytes
    (8, False, True),    # base 16 bytes on
])
def test_tma_ready_checks_base_and_strides(offset, transpose, want):
    B, H, S, hd = 2, 4, 40, 64
    buf = torch.zeros(B * H * S * hd + 8, dtype=torch.bfloat16)
    flat = buf[offset:offset + B * H * S * hd]
    t = flat.view(B, S, H, hd).transpose(1, 2) if transpose else flat.view(B, H, S, hd)
    assert fa.tma_ready(t) is want


def test_tma_ready_refuses_strides_off_eight_elements():
    t = torch.zeros(2, 4, 40, 68, dtype=torch.bfloat16)[..., :64]  # row stride 68
    assert not fa.tma_ready(t)
    assert fa.tma_ready(fa.tma_copy(t))


def test_tma_copy_moves_a_misaligned_base():
    buf = torch.arange(2 * 4 * 40 * 64 + 1, dtype=torch.float32).to(torch.bfloat16)
    t = buf[1:].view(2, 4, 40, 64)  # contiguous, base 2 bytes off
    assert t.is_contiguous() and not fa.tma_ready(t)
    c = fa.tma_copy(t)
    assert fa.tma_ready(c) and torch.equal(c, t) and c.data_ptr() != t.data_ptr()
    ok = torch.zeros(2, 4, 40, 64, dtype=torch.bfloat16)
    assert fa.tma_copy(ok) is ok


def _c_params(name):
    """The ctypes kinds of a C entry point's parameters, read from its
    definition in csrc/*.cu."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    src = "".join(p.read_text() for p in _build._sources())
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if param.startswith("const long long*"):
            kinds.append(ctypes.POINTER(ctypes.c_longlong))
        elif param.startswith("int*"):
            kinds.append(ctypes.POINTER(ctypes.c_int))
        elif "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("long long"):
            kinds.append(ctypes.c_longlong)
        elif param.startswith("float"):
            kinds.append(ctypes.c_float)
        else:
            assert param.startswith("int "), param
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("name", ["rt_flash_attention_bwd", "rt_flash_attention", "rt_rmsnorm",
                                  "rt_rmsnorm_bwd", "rt_flash_decode", "rt_wkv6", "rt_wkv6_bwd",
                                  "rt_rglru", "rt_rglru_bwd", "rt_rglru_blocks_per_sm",
                                  "rt_wkv6_plan"])
def test_c_entry_points_match_their_ctypes_signatures(name):
    """ctypes passes every argument as the wrapper's SIGNATURES say: one
    kind too few or in the wrong place would cut a pointer or shift the
    strides. The sources are parsed here; nothing is built."""
    from repro_torch.kernels import _build

    assert _c_params(name) == _build.SIGNATURES[name]


@pytest.mark.parametrize("name", ["rt_flash_attention", "rt_flash_attention_bwd"])
def test_flash_entry_points_take_the_key_length_after_the_queries(name):
    """The forward's and the backward's C entry points take the keys' length
    Sk right after the queries' S and before hd (the wrappers pass ``B, H,
    K, S, Sk, hd``), both as C ints."""
    import re

    from repro_torch.kernels import _build

    src = "".join(p.read_text() for p in _build._sources())
    params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    names = [" ".join(p.split()).split(" ")[-1] for p in params.split(",")]
    i = names.index("S")
    assert names[i - 3:i + 3] == ["B", "H", "K", "S", "Sk", "hd"], names
