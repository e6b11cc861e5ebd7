"""The float32 route of the flash-attention forward (``csrc/flash_attention.cu``,
``flash_f32_kernel``), emulated in torch and held against the reference's
``attention_ref`` (through JAX) and the port's plain version on the same
numpy inputs.

The emulation follows the kernel's arithmetic: keys in tiles of 32; every
operand of the two products split into TF32 parts, hi = tf32(x) and lo =
tf32(x - hi), with TF32 rounding done by the bit operations the kernel uses
(round to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds);
S = hi·hi + (hi·lo + lo·hi), the two small products in their own sum; an
online softmax in float32 (exp2 with the scale folded in, the running max
starting at -1e30); O rescaled, then P·V added as hi·hi, hi·lo, lo·hi for
each k-step of 8 keys in order; O / max(l, 1e-30) and the natural-log lse.
A matrix product inside the emulation sums in torch's order, not the
tensor cores': the emulation checks the roundings, and on the card
``chip_smoke.py`` holds the kernel itself against ``flash_attention_ref``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as fa

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

KEY_TILE = 32  # the kernel's keys per k-tile
K_STEP = 8  # keys per mma k-step of P·V
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INIT = -1.0e30
TOL = 2e-5  # chip_smoke.TOL["float32"]: atol and rtol
LSE_TOL = (1e-4, 1e-5)  # chip_smoke.LSE_TOL: (atol, rtol)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it: add half of TF32's last
    place to the bits and clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000: 0xffffe000


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _mask(S, k0, k1, causal, window):
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(k0, k1)[None, :]
    ok = torch.ones((S, k1 - k0), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def emulate(q, k, v, *, causal=True, window=0, three_passes=True):
    """The kernel's arithmetic on float32 (B, H, S, hd) q and (B, K, S, hd)
    k, v; returns (out, lse). With ``three_passes`` False each operand is
    rounded to TF32 once and each product is one pass."""
    B, H, S, hd = q.shape
    g = H // k.shape[1]
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    # the wrapper passes the scale as a C float; the host folds in log2(e)
    scale_log2 = float(np.float32(np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)))

    def parts(x):
        return split(x) if three_passes else (tf32(x), None)

    qh, ql = parts(q)
    m = torch.full((B, H, S), NEG_INIT)
    l = torch.zeros((B, H, S))
    o = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, KEY_TILE):
        k1 = min(k0 + KEY_TILE, S)
        kh, kl = parts(kk[:, :, k0:k1])
        s = qh @ kh.transpose(-1, -2)
        if three_passes:
            s = s + (qh @ kl.transpose(-1, -2) + ql @ kh.transpose(-1, -2))
        x = torch.where(_mask(S, k0, k1, causal, window), s * scale_log2,
                        torch.tensor(-math.inf))
        mn = torch.maximum(m, torch.clamp(x.amax(dim=-1), min=NEG_INIT))
        a = torch.exp2(m - mn)
        p = torch.exp2(x - mn[..., None])
        l = l * a + p.sum(dim=-1)
        m = mn
        o = o * a[..., None]
        for s0 in range(0, k1 - k0, K_STEP):
            ph, pl = parts(p[..., s0:s0 + K_STEP])
            vh, vl = parts(vv[:, :, k0 + s0:min(k0 + s0 + K_STEP, k1)])
            o = o + ph @ vh
            if three_passes:
                o = o + ph @ vl
                o = o + pl @ vh
    guard = torch.clamp(l, min=1e-30)
    return o / guard[..., None], (m + torch.log2(guard)) * LN2


def _inputs(rng, B, H, K, S, hd):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd))]


CASES = {  # B, H, K, S, hd, causal, window
    "causal_hd16": (1, 2, 2, 96, 16, True, 0),
    "causal_hd64": (2, 2, 2, 128, 64, True, 0),
    "causal_hd256": (1, 2, 2, 128, 256, True, 0),
    "window48_hd64": (1, 2, 2, 160, 64, True, 48),
    "gqa_g2_hd64": (1, 4, 2, 128, 64, True, 0),
    "ragged_s200_gqa_g2_hd64": (1, 4, 2, 200, 64, True, 0),
    "ragged_s77_hd256": (2, 2, 2, 77, 256, True, 0),
    "not_causal_hd64": (1, 2, 2, 100, 64, False, 0),
    "not_causal_window48_hd256": (1, 4, 2, 130, 256, False, 48),
    "ragged_s200_mha_hd96": (1, 4, 4, 200, 96, True, 0),
    "window48_gqa_g2_hd96": (1, 4, 2, 130, 96, True, 48),
}


def _within(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_within_float32_tolerance_of_jax_reference(case):
    B, H, K, S, hd, causal, window = CASES[case]
    q, k, v = _inputs(np.random.default_rng(S + 7 * hd + H + window), B, H, K, S, hd)
    got, _ = emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=window)
    _within(got, want, TOL, TOL, case)


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_and_lse_within_tolerance_of_plain_version(case):
    """The comparison chip_smoke.py makes with the kernel on the card."""
    B, H, K, S, hd, causal, window = CASES[case]
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(np.random.default_rng(S + 7 * hd + H + window + 1), B, H, K, S, hd))
    got, lse = emulate(q, k, v, causal=causal, window=window)
    want, lse_want = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                            return_lse=True)
    _within(got, want, TOL, TOL, case)
    _within(lse, lse_want, *LSE_TOL, f"{case} lse")


def test_one_tf32_rounding_breaks_the_float32_tolerance():
    """Why the kernel splits each operand: with one TF32 rounding and one
    pass per product, hd 256 leaves the float32 tolerance; the split keeps
    the error near float32's own."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(np.random.default_rng(256), 1, 4, 4, 256, 256))
    want = fa.flash_attention_ref(q, k, v)

    def err(three_passes):
        got, _ = emulate(q, k, v, three_passes=three_passes)
        return float(((got - want).abs() - TOL * want.abs()).max())

    split_err, one_err = err(True), err(False)
    assert split_err <= TOL < one_err
    assert one_err > 10 * TOL


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),       # below the tie: down
    (2.0 - 2.0 ** -23, 2.0),                     # carries into the exponent
    (3.0, 3.0),                                  # already TF32
])
def test_tf32_rounding_is_to_nearest_ties_away(x, want):
    assert tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_split_recovers_float32_to_two_pow_minus_22():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(10000).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert torch.all((part.view(torch.int32) & 0x1FFF) == 0)  # both are TF32
    assert torch.all((hi + lo - x).abs() <= 2.0 ** -22 * x.abs())


@pytest.mark.parametrize("make,copied", [
    (lambda: torch.zeros(1 * 4 * 40 * 64 + 1)[1:].view(1, 4, 40, 64), True),  # base 4 bytes off
    (lambda: torch.zeros(1, 4, 40, 66)[..., :64], True),  # row stride 66, not a multiple of 4
    (lambda: torch.zeros(1, 40, 4, 64).transpose(1, 2), False),  # a (B, S, H, hd) buffer's view
    (lambda: torch.zeros(1, 4, 40, 68)[..., :64], False),  # row stride 68
])
def test_float32_alignment_rule_copies_only_what_breaks_it(make, copied):
    """The float32 kernel's 16-byte cp.async copies need a 16-byte aligned
    base and batch, head and sequence strides that are multiples of 4
    floats: the wrapper runs the same kernel on a copy of a tensor that
    breaks the rule, and passes any other as it is."""
    t = make()
    assert fa.tma_ready(t) is not copied
    c = fa.tma_copy(t)
    assert (c is not t) is copied
    assert fa.tma_ready(c) and torch.equal(c, t)
