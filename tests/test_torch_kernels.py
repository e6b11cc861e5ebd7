"""The port's plain kernel versions against the JAX Pallas kernels (interpret
mode, as tests/test_kernels.py runs them), on the same numpy inputs.

On the CPU the port's dispatch (``repro_torch.kernels.ops``) runs exactly
these plain versions; chip_smoke.py holds the CUDA kernels against them on
the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.ref import rglru_ref as jax_rglru_ref
from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rwkv6 import wkv6 as jax_wkv6
from repro.models.layers import _sdpa
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as lru
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rwkv6

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = 3e-5
WKV6_TOL = 3e-5  # tests/test_kernels.py: chunked float32 sums against the sequential oracle
WKV6_STRONG_DECAY_TOL = 1e-4
RGLRU_TOL = 2e-5


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(want_j.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _ring_kpos(B, W, pos):
    """Slot s holds the latest position p <= pos with p % W == s, else -1."""
    s = np.arange(W)
    kp = np.where(s <= pos, s + W * ((pos - s) // W), -1).astype(np.int32)
    return np.broadcast_to(kp, (B, W)).copy()


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (3, 100),
                                   (8, 2048), (4, 1, 4096), (16, 4096)])  # the served widths
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = jax_rmsnorm(xj, jnp.asarray(scale))
    ops.reset_launch_counts()
    got = ops.rmsnorm(xt, torch.from_numpy(scale))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, TOL[dtype])
    _close(rn.rmsnorm_ref(xt, torch.from_numpy(scale)), want, TOL[dtype])
    assert ops.launch_counts()["rmsnorm"] == 0  # the CPU never launches a kernel


@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (2, 4, 2, 64, 16, 0),     # GQA
    (1, 8, 1, 128, 32, 0),    # MQA, gemma-style
    (2, 4, 2, 64, 16, 16),    # sliding window
    (1, 8, 1, 128, 256, 0),   # gemma-2b's heads: MQA at hd 256
    (1, 16, 1, 128, 256, 64),  # recurrentgemma-9b's: 16 heads on one KV head, window
    (1, 4, 4, 128, 96, 0),    # phi-3-vision's heads: MHA at hd 96
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, H, K, S, hd, window, dtype):
    rng = np.random.default_rng(B * 1000 + S + window)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    want = jax_flash_attention(qj, kj, vj, window=window, block_q=32, block_k=32,
                               interpret=True)
    _close(ops.flash_attention(qt, kt, vt, window=window), want, TOL[dtype])


def _tensor_core_flash_emulation(q, k, v, window):
    """The bf16 CUDA kernel's arithmetic in float32 torch: 64-key tiles, an
    online softmax in base 2 with the scale folded in, P rounded to bf16
    before P·V, float32 accumulation, the output rounded to bf16.
    q: (B, H, S, hd), k/v: (B, K, S, hd), all bf16."""
    B, H, S, hd = q.shape
    g = H // k.shape[1]
    qf = q.float()
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    scale_log2 = (1.0 / np.sqrt(hd)) * np.log2(np.e)
    m = torch.full((B, H, S), -1.0e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        kpos = torch.arange(k0, min(k0 + 64, S))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + 64]) * scale_log2
        ok = kpos <= qpos
        if window:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + 64])
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_bf16_probabilities_within_tolerance(window):
    """Rounding P to bf16 for the tensor-core P·V (the CUDA kernel's bf16
    route) keeps the output within the bf16 tolerance of the Pallas kernel,
    which keeps P in float32: hd 256, S 256, causal, 16 heads on one KV
    head."""
    B, H, K, S, hd = 1, 16, 1, 256, 256
    rng = np.random.default_rng(256 + window)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    want = jax_flash_attention(qj, kj, vj, window=window, interpret=True)
    got = _tensor_core_flash_emulation(qt, kt, vt, window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, hd)
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("case", ["empty_slots", "window", "wrapped_ring", "no_valid_slot",
                                  "window_excludes_whole_chunks"])
def test_flash_decode_plain_matches_pallas(case):
    B, H, K, S, hd = 2, 4, 2, 128, 32
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    pos, window = {"empty_slots": (S - 10, 0), "window": (S - 10, 32),
                   "wrapped_ring": (3 * S + 17, 0), "no_valid_slot": (S - 10, 0),
                   "window_excludes_whole_chunks": (3 * S + 17, 20)}[case]
    kpos = _ring_kpos(B, S, pos)
    if case == "no_valid_slot":  # every slot empty: both give the mean of V
        kpos[:] = -1
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
                            jnp.int32(pos), window=window, block_k=32, interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(kpos), pos, window=window)
    _close(got, want, DECODE_TOL)


def _decode_kernel_emulation(q, k, v, kpos, pos, window=0, split_p=False):
    """The CUDA kernel's arithmetic in float32 torch: the cache cut by the
    wrapper's own rule (``decode_plan`` for a 132-SM card), per chunk a
    partial (max, sum, unnormalised accumulator) over its valid slots or an
    empty one (sum 0), the chunks of each cluster combined in rank order.
    Each rank of a cluster writes its slice of the (head, column pair) items
    to scratch, and the (max, sum) of each head at the slice's first item of
    it, into its own rank's entry; the last block of each rank then combines
    its slice across the clusters in cluster order, or takes the mean of V
    over all slots when the row has no valid slot. The ranks run in reverse
    order, each to its final combine before the next writes, and the scratch
    starts as NaN: a rank that read what only another rank writes would
    fail here.
    ``split_p``: the weights enter P·V as their bf16 high part plus the bf16
    rounding of the rest, as the bf16 kernel's tensor cores take them (the
    sum stays float32).
    q: (B, H, hd), k/v: (B, K, S, hd), kpos: (B, S), all torch."""
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    g, npair = H // K, hd // 2
    chunk, n_chunks = da.decode_plan(S, B * K, 132)
    n_blocks = -(-n_chunks // da.CLUSTER) * da.CLUSTER  # padded with empty blocks
    n_clusters = n_blocks // da.CLUSTER
    per = -(-g * npair // da.CLUSTER)  # items per rank
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)

    def combine(parts):
        """(max, sum, acc) partials in order; an empty one (sum 0) is skipped."""
        used = [p for p in parts if float(p[1].max()) > 0]
        if not used:
            return torch.full((g,), -1.0e30), torch.zeros(g), torch.zeros((g, hd))
        M = torch.stack([p[0] for p in used]).max(dim=0).values
        L, acc = torch.zeros(g), torch.zeros((g, hd))
        for m, l, a in used:
            L = L + torch.exp(m - M) * l
            acc = acc + torch.exp(m - M)[:, None] * a
        return M, L, acc

    out = torch.full((B, H, hd), float("nan"))
    for b in range(B):
        for kvh in range(K):
            qs = q[b, kvh * g:(kvh + 1) * g].float()  # (g, hd)
            chunks = []
            for split in range(n_blocks):
                sl = torch.arange(min(S, split * chunk), min(S, (split + 1) * chunk))
                sl = sl[valid[b, sl]]
                if len(sl) == 0:
                    chunks.append((torch.full((g,), -1.0e30), torch.zeros(g), None))
                    continue
                s = qs @ k[b, kvh, sl].float().T / np.sqrt(hd)  # (g, n)
                m = s.max(dim=1).values
                w = torch.exp(s - m[:, None])
                if split_p:
                    hi = w.to(torch.bfloat16).float()
                    wv = hi + (w - hi).to(torch.bfloat16).float()
                else:
                    wv = w
                chunks.append((m, w.sum(dim=1), wv @ v[b, kvh, sl].float()))
            clusters = [combine(chunks[c:c + da.CLUSTER])
                        for c in range(0, n_blocks, da.CLUSTER)]
            part_acc = torch.full((n_clusters, g * npair, 2), float("nan"))
            part_ml = torch.full((n_clusters, da.CLUSTER, g, 2), float("nan"))
            for rank in reversed(range(da.CLUSTER)):
                items = torch.arange(rank * per, min(g * npair, (rank + 1) * per))
                if len(items) == 0:
                    continue
                heads, d = items // npair, items % npair * 2
                first = heads[(d == 0) | (items == items[0])]
                for c, (M, L, acc) in enumerate(clusters):
                    part_acc[c, items] = acc.reshape(-1, 2)[items]
                    part_ml[c, rank, first] = torch.stack([M[first], L[first]], dim=-1)
                ml, x = part_ml[:, rank, heads], part_acc[:, items]  # (n_clusters, n, 2)
                assert not (ml.isnan().any() or x.isnan().any()), "scratch read before written"
                used = ml[..., 1] > 0
                top = torch.where(used, ml[..., 0], -torch.inf).max(dim=0).values
                w = torch.where(used, torch.exp(ml[..., 0] - top), 0.0)
                L = (w * ml[..., 1]).sum(dim=0)
                acc = (w[..., None] * x).sum(dim=0)  # (n, 2)
                cols = torch.stack([d, d + 1], dim=-1)
                mean = v[b, kvh].float().mean(dim=0)[cols]  # no valid slot in the row
                res = torch.where((L > 0)[:, None], acc / L[:, None], mean)
                out[b, kvh * g + heads[:, None], cols] = res
    return out


@pytest.mark.parametrize("case", [
    # (B, H, K, S, hd, pos, window, empty_rows)
    ("ragged_last_chunk", 1, 8, 1, 100, 32, 99, 0, 0),
    ("chunks_with_no_valid_slot", 2, 4, 2, 128, 32, 3 * 128 + 17, 20, 0),
    ("wrapped_ring", 2, 4, 2, 96, 64, 5 * 96 + 40, 0, 0),
    ("g16_hd256", 1, 16, 1, 160, 256, 120, 0, 0),
    ("hd16", 2, 4, 1, 64, 16, 40, 0, 0),
    ("no_valid_slot", 2, 4, 2, 64, 32, 40, 0, 1),
    # groups of 1, 2 and 4 over several clusters: a rank's slice starts inside a head
    ("g1_clusters", 4, 4, 4, 640, 64, 647, 0, 0),
    ("g2_clusters", 2, 4, 2, 1024, 128, 1031, 0, 1),
    ("g4_hd16_clusters", 4, 4, 1, 320, 16, 327, 100, 0),
], ids=lambda c: c[0])
def test_decode_kernel_emulation_matches_pallas(case):
    """The chunked partials, the split-order combine, the per-rank slices of
    the last combine and the empty-row branch of the CUDA kernel give the
    Pallas kernel's result in float32."""
    _, B, H, K, S, hd, pos, window, empty_rows = case
    rng = np.random.default_rng(S + hd)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    kpos = _ring_kpos(B, S, pos)
    kpos[:empty_rows] = -1
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
                            jnp.int32(pos), window=window, block_k=32, interpret=True)
    got = _decode_kernel_emulation(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(kpos), pos, window)
    _close(got, want, DECODE_TOL)


@pytest.mark.parametrize("window", [0, 48])
def test_decode_kernel_bf16_probabilities_within_tolerance(window):
    """P as a bf16 high part and a bf16 low part for the tensor-core P·V
    (the bf16 kernel) keeps the output within the bf16 tolerance of the
    Pallas kernel, which keeps P in float32: recurrentgemma-9b's 16 heads
    on one KV head at hd 256."""
    B, H, K, S, hd, pos = 2, 16, 1, 192, 256, 250
    rng = np.random.default_rng(192 + window)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    kpos = _ring_kpos(B, S, pos)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    want = jax_flash_decode(qj, kj, vj, jnp.asarray(kpos), jnp.int32(pos), window=window,
                            interpret=True)
    got = _decode_kernel_emulation(qt, kt, vt, torch.from_numpy(kpos), pos, window,
                                   split_p=True).to(torch.bfloat16)
    _close(got, want, TOL["bfloat16"])


def test_decode_plan_fills_the_card():
    """The chunk rule: a block per SM where S allows, chunks of MIN_CHUNK to
    MAX_CHUNK slots, never more chunks than slots; at gemma-2b's decode
    shape (4 rows, 544 slots) 156 blocks with a chunk (160 with the
    cluster padding) where 64-slot chunks gave 36."""
    sms = 132
    assert da.decode_plan(544, 4, sms) == (14, 39)
    assert -(-544 // 64) * 4 == 36
    chunk, n_chunks = da.decode_plan(2048, 4, sms)  # recurrentgemma-9b
    assert 32 <= chunk <= 64 and 4 * n_chunks >= sms
    for S in (1, 7, 16, 40, 100, 544, 2048, 4096, 100_000):
        for rows in (1, 4, 8, 33, 132, 256):
            chunk, n_chunks = da.decode_plan(S, rows, sms)
            assert da.MIN_CHUNK <= chunk <= da.MAX_CHUNK
            assert n_chunks == -(-S // chunk) and n_chunks <= S
            if S >= da.MIN_CHUNK * -(-sms // rows):
                assert rows * n_chunks >= sms


def test_flash_decode_on_port_cache_layout_matches_model_path():
    """The port hands the kernel its (B, W, n, hd) cache as a strided view;
    the result equals the JAX model's decode attention (``_sdpa``)."""
    B, H, K, S, hd = 2, 4, 2, 64, 16
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, S, K, hd)).astype(np.float32)  # the model's layout
    cv = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    pos = 40
    kpos = _ring_kpos(B, S, pos)
    want = _sdpa(
        jnp.asarray(q).reshape(B, 1, K, H // K, hd), jnp.asarray(ck), jnp.asarray(cv),
        qpos=jnp.full((B, 1), pos, jnp.int32), kpos=jnp.asarray(kpos),
        kvalid=jnp.asarray(kpos) >= 0, window=0, causal=True,
    ).reshape(B, H, hd)
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = da.flash_decode_ref(torch.from_numpy(q), tck.transpose(1, 2), tcv.transpose(1, 2),
                              torch.from_numpy(kpos), pos)
    _close(got, want, DECODE_TOL)


def test_flash_attention_plain_is_the_reference_oracle():
    """The port's plain version equals ``repro.kernels.ref.attention_ref``
    at a sequence length no Pallas block divides."""
    from repro.kernels.ref import attention_ref

    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 37, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 37, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 37, 16)).astype(np.float32)
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8)
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 window=8)
    _close(got, want, TOL["float32"])


def _wkv6_inputs(B, H, S, N, seed, strong_decay=False):
    """The distributions of tests/test_kernels.py's wkv6 cases, from numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32) for _ in range(3))
    if strong_decay:  # decay ~ e^-8 per step, u = 0, zero state
        wlog = np.full((B, H, S, N), -8.0, dtype=np.float32)
        u = np.zeros((H, N), dtype=np.float32)
        st = np.zeros((B, H, N, N), dtype=np.float32)
        return r, k, v, wlog, u, st
    r, k, v = r * 0.5, k * 0.5, v * 0.5
    wlog = -np.exp(rng.standard_normal((B, H, S, N)).astype(np.float32) * 0.5 - 1)
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, wlog, u, st


def _wkv6_both(inputs, chunk):
    jax_args = [jnp.asarray(a) for a in inputs]
    pallas = jax_wkv6(*jax_args, chunk=chunk, interpret=True)
    oracle = jax_wkv6_ref(*jax_args)
    return pallas, oracle


@pytest.mark.parametrize("B,H,S,N", [(1, 1, 32, 8), (2, 4, 128, 16), (1, 2, 96, 32)])
@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_plain_matches_pallas_and_oracle(B, H, S, N, chunk):
    inputs = _wkv6_inputs(B, H, S, N, seed=S + N + chunk)
    ops.reset_launch_counts()
    y, st = ops.wkv6(*(torch.from_numpy(a) for a in inputs))
    assert y.shape == (B, H, S, N) and y.dtype == torch.float32 and st.dtype == torch.float32
    for want_y, want_st in _wkv6_both(inputs, chunk):
        _close(y, want_y, WKV6_TOL)
        _close(st, want_st, WKV6_TOL)
    assert ops.launch_counts()["wkv6"] == 0


def test_wkv6_plain_strong_decay_is_finite():
    """wlog = -8 over 256 tokens: every exponent the plain version takes is
    <= 0, so nothing overflows."""
    inputs = _wkv6_inputs(1, 2, 256, 16, seed=0, strong_decay=True)
    y, st = rwkv6.wkv6_ref(*(torch.from_numpy(a) for a in inputs))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for want_y, want_st in _wkv6_both(inputs, chunk=128):
        _close(y, want_y, WKV6_STRONG_DECAY_TOL)
        _close(st, want_st, WKV6_STRONG_DECAY_TOL)


def test_wkv6_plain_bf16_rkv_with_f32_decay():
    """The model's types: r/k/v bfloat16, wlog/u/state float32; y comes back
    in bfloat16, the state in float32."""
    r, k, v, wlog, u, st = _wkv6_inputs(2, 4, 128, 16, seed=11)
    (rj, rt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (r, k, v))
    f32 = [torch.from_numpy(a) for a in (wlog, u, st)]
    y, st_out = ops.wkv6(rt, kt, vt, *f32)
    assert y.dtype == torch.bfloat16 and st_out.dtype == torch.float32
    jf32 = [jnp.asarray(a) for a in (wlog, u, st)]
    for want_y, want_st in (jax_wkv6(rj, kj, vj, *jf32, chunk=64, interpret=True),
                            jax_wkv6_ref(rj, kj, vj, *jf32)):
        _close(y, want_y, TOL["bfloat16"])
        _close(st_out, want_st, TOL["bfloat16"])


def test_wkv6_plain_ragged_length_and_strided_views():
    """S = 300 (no power-of-two chunk divides it) on (B, S, H, N) buffers
    passed as (B, H, S, N) views, as the model passes them."""
    inputs = _wkv6_inputs(1, 2, 300, 16, seed=5)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
             for a in inputs[:4]]
    y, st = rwkv6.wkv6_ref(*views, *(torch.from_numpy(a) for a in inputs[4:]))
    want_y, want_st = jax_wkv6_ref(*(jnp.asarray(a) for a in inputs))
    _close(y, want_y, WKV6_TOL)
    _close(st, want_st, WKV6_TOL)


def _wkv6_kernel_emulation(r, k, v, wlog, u, state):
    """csrc/wkv6.cu's arithmetic in torch, float32, with the thread tiles of
    rwkv6.TILES[N]. Per (b, h) and tile of rwkv6.TILE tokens: each token's
    bonus r . (u * k) in parts of N / parts rows (parts = threads / TILE),
    each summed in row order, then the parts in order. Per token, each
    column's rows in G = N / R groups of R rows: a group sums its R products
    r_i s_i in row order, a butterfly adds the groups (g ^ 1, then g ^ 2,
    ...; the kernel's lanes carry different columns through its first
    steps, which sums the same pairs), then + bonus * v_j; each row is
    updated as s_i * exp(w_i) + k_i * v_j."""
    B, H, S, N = r.shape
    R, C, JC = rwkv6.TILES[N]
    G = N // R
    parts = rwkv6.launch_plan(1, 1, N)[1] // rwkv6.TILE
    r, k, v, wlog = (t.float() for t in (r, k, v, wlog))
    s = state.float().clone().view(B, H, G, R, N)  # s[..., g, q, j] = S[g * R + q][j]
    uf = u.float()[None, :, None, :]
    y = torch.empty((B, H, S, N))
    for t0 in range(0, S, rwkv6.TILE):
        n = min(rwkv6.TILE, S - t0)
        rt, kt, vt = (x[:, :, t0:t0 + n] for x in (r, k, v))
        wt = torch.exp(wlog[:, :, t0:t0 + n])
        p = (rt * (uf * kt)).view(B, H, n, parts, N // parts)
        sums = [p[..., c, 0] for c in range(parts)]
        for q in range(1, N // parts):
            sums = [sm + p[..., c, q] for c, sm in enumerate(sums)]
        bonus = sums[0]
        for sm in sums[1:]:
            bonus = bonus + sm
        for tt in range(n):
            rg, kg, wg = (x[:, :, tt].view(B, H, G, R) for x in (rt, kt, wt))
            vj = vt[:, :, tt][:, :, None, :]  # (B, H, 1, N)
            acc = torch.zeros((B, H, G, N))
            for q in range(R):
                acc = acc + rg[..., q, None] * s[..., q, :]
                s[..., q, :] = s[..., q, :] * wg[..., q, None] + kg[..., q, None] * vj
            o = 1
            while o < G:
                acc = acc + acc[:, :, torch.arange(G) ^ o]
                o *= 2
            y[:, :, t0 + tt] = acc[:, :, 0] + bonus[:, :, tt, None] * vj[:, :, 0]
    return y, s.view(B, H, N, N)


@pytest.mark.parametrize("B,H,S,N,strong_decay", [
    (1, 1, 32, 8, False), (2, 4, 128, 16, False), (1, 2, 96, 32, False),  # the reference's
    (1, 2, 70, 64, False),  # the served head size, a short last tile
    (1, 2, 96, 64, True)])  # wlog = -8
def test_wkv6_kernel_emulation_matches_pallas_and_oracle(B, H, S, N, strong_decay):
    inputs = _wkv6_inputs(B, H, S, N, seed=S + N + 7, strong_decay=strong_decay)
    y, st = _wkv6_kernel_emulation(*(torch.from_numpy(a) for a in inputs))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = WKV6_STRONG_DECAY_TOL if strong_decay else WKV6_TOL
    for want_y, want_st in _wkv6_both(inputs, chunk=64):
        _close(y, want_y, tol)
        _close(st, want_st, tol)


def test_wkv6_launch_plan_fits_the_card():
    """The kernel's grid at rwkv6-1.6b's prefill shape is 512 blocks, all
    resident in one wave on an H100's 132 SMs (228 KB of shared memory an
    SM); every head size gives whole warps of whole column groups, at most
    1024 threads a block, and a thread per staged row."""
    blocks, threads, smem = rwkv6.launch_plan(4, 32, 64)
    assert (blocks, threads) == (512, 64)
    assert smem * -(-blocks // 132) <= 228 * 1024
    for N in rwkv6.HEAD_SIZES:
        R, C, JC = rwkv6.TILES[N]
        G = N // R
        blocks, threads, smem = rwkv6.launch_plan(2, 3, N)
        assert N % JC == 0 and JC % C == 0 and C <= G <= 32 and 32 % G == 0
        assert blocks == 2 * 3 * (N // JC) and threads == JC // C * G <= 1024
        assert threads % 32 == 0 and threads % N == 0 and threads % rwkv6.TILE == 0
        assert smem <= 48 * 1024


@pytest.mark.parametrize("B,S,W", [(1, 64, 32), (2, 128, 64), (2, 192, 128), (2, 300, 96)])
def test_rglru_plain_matches_pallas_and_oracle(B, S, W):
    rng = np.random.default_rng(S + W)
    log_a = -np.exp(rng.standard_normal((B, S, W)).astype(np.float32) * 0.5)
    m = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    ops.reset_launch_counts()
    h_seq, h_final = ops.rglru(*(torch.from_numpy(a) for a in (log_a, m, h0)))
    assert h_seq.shape == (B, S, W) and h_final.shape == (B, W)
    jax_args = [jnp.asarray(a) for a in (log_a, m, h0)]
    for want_seq, want_final in (jax_rglru_scan(*jax_args, chunk=32, block_w=32, interpret=True),
                                 jax_rglru_ref(*jax_args)):
        _close(h_seq, want_seq, RGLRU_TOL)
        _close(h_final, want_final, RGLRU_TOL)
    assert ops.launch_counts()["rglru"] == 0


def _rglru_inputs(B, S, W, seed):
    """tests/test_kernels.py's rglru distributions, from numpy."""
    rng = np.random.default_rng(seed)
    log_a = -np.exp(rng.standard_normal((B, S, W)).astype(np.float32) * 0.5)
    m = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return log_a, m, h0


@pytest.mark.parametrize("B,S,W", [(1, 64, 32), (2, 128, 64), (2, 192, 128)])
def test_rglru_plain_bf16_inputs_match_pallas_and_oracle(B, S, W):
    """bf16 log_a and m, float32 h0: the plain version reads them as the
    Pallas kernel does (cast to float32) and returns float32."""
    log_a, m, h0 = _rglru_inputs(B, S, W, seed=S + W + 1)
    (aj, at), (mj, mt) = _pair(log_a, "bfloat16"), _pair(m, "bfloat16")
    h_seq, h_final = ops.rglru(at, mt, torch.from_numpy(h0))
    assert h_seq.dtype == h_final.dtype == torch.float32
    h0j = jnp.asarray(h0)
    for want_seq, want_final in (jax_rglru_scan(aj, mj, h0j, chunk=32, block_w=32, interpret=True),
                                 jax_rglru_ref(aj, mj, h0j)):
        _close(h_seq, want_seq, RGLRU_TOL)
        _close(h_final, want_final, RGLRU_TOL)


def _rglru_kernel_emulation(log_a, m, h0):
    """csrc/rglru.cu's order of work in torch: per batch row, slabs of
    lru.SLAB channels; per slab, tiles of lru.tile_tokens(elem) tokens (the
    last one short) staged as the kernel's copies stage them (copies of
    `vec` bytes from the row's first whole copy, the one holding the slab's
    last element reading only the slab, the rest of it zero-filled; copies
    past it never started and left NaN); then per token one a * h + m per
    channel. Fails if a channel reads an element no copy staged or a copy
    reads outside the tensor."""
    log_a, m, h0 = lru.kernel_inputs(log_a, m, h0)
    B, S, W = log_a.shape
    elem = log_a.element_size()
    vec = lru.copy_bytes(W, elem, log_a.data_ptr(), m.data_ptr())
    assert all(t.data_ptr() % vec == 0 for t in (log_a, m))  # whole copies from the base
    E, TT, SLAB = vec // elem, lru.tile_tokens(elem), lru.SLAB
    pitch = -(-(SLAB + (0 if vec == 16 else E - 1)) // E) * E
    flat = [t.reshape(-1) for t in (log_a, m)]
    k = torch.arange(pitch)
    h_seq = torch.full((B, S, W), float("nan"))
    h_final = torch.full((B, W), float("nan"))
    for b in range(B):
        for w0 in range(0, W, SLAB):
            nv = min(SLAB, W - w0)
            h = h0[b, w0:w0 + nv].clone()
            for t0 in range(0, S, TT):
                g = (b * S + t0 + torch.arange(min(TT, S - t0)))[:, None] * W + w0  # (rows, 1)
                o = g % E if vec != 16 else torch.zeros_like(g)
                if vec == 16:
                    assert bool((g % E == 0).all())
                src = g - o + k  # (rows, pitch)
                read = src < g + nv
                started = g - o + k // E * E < g + nv
                assert int(src[read].max()) < flat[0].numel()
                tiles = []
                for f in flat:
                    tile = torch.full(src.shape, float("nan"))
                    tile[started] = 0.0
                    tile[read] = f[src[read]].float()
                    tiles.append(tile)
                lanes = o + torch.arange(nv)  # (rows, nv)
                a, x = (t.gather(1, lanes) for t in tiles)
                assert not (a.isnan().any() or x.isnan().any()), "read an unstaged element"
                for r in range(len(g)):
                    h = torch.exp(a[r]) * h + x[r]
                    h_seq[b, t0 + r, w0:w0 + nv] = h
            h_final[b, w0:w0 + nv] = h
    return h_seq, h_final


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", [(1, 64, 32), (2, 128, 64), (2, 192, 128),  # the reference's
                                   (2, 300, 96), (2, 1, 64)])  # short last tile; S = 1
def test_rglru_kernel_emulation_matches_pallas_and_oracle(B, S, W, dtype):
    log_a, m, h0 = _rglru_inputs(B, S, W, seed=S + W + 2)
    (aj, at), (mj, mt) = _pair(log_a, dtype), _pair(m, dtype)
    h_seq, h_final = _rglru_kernel_emulation(at, mt, torch.from_numpy(h0))
    h0j = jnp.asarray(h0)
    for want_seq, want_final in (jax_rglru_scan(aj, mj, h0j, chunk=32, block_w=32, interpret=True),
                                 jax_rglru_ref(aj, mj, h0j)):
        _close(h_seq, want_seq, RGLRU_TOL)
        _close(h_final, want_final, RGLRU_TOL)


@pytest.mark.parametrize("W,dtype,vec", [(98, "float32", 4), (99, "float32", 4),
                                         (100, "bfloat16", 4), (99, "bfloat16", 4),
                                         (40, "float32", 16)])
def test_rglru_kernel_emulation_on_unaligned_rows_matches_oracle(W, dtype, vec):
    """Rows that are not 16-byte aligned take 4-byte copies; bf16 rows of odd
    W start on odd elements half the time (read from the element before);
    W = 40 has a partial slab on 16-byte copies."""
    log_a, m, h0 = _rglru_inputs(2, 130, W, seed=W)
    (aj, at), (mj, mt) = _pair(log_a, dtype), _pair(m, dtype)
    assert lru.copy_bytes(W, at.element_size(), at.data_ptr(), mt.data_ptr()) == vec
    h_seq, h_final = _rglru_kernel_emulation(at, mt, torch.from_numpy(h0))
    want_seq, want_final = jax_rglru_ref(aj, mj, jnp.asarray(h0))
    _close(h_seq, want_seq, RGLRU_TOL)
    _close(h_final, want_final, RGLRU_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_kernel_emulation_on_a_base_one_element_off(dtype):
    """log_a as a view one element past an aligned base: float32 takes
    4-byte copies, bf16 is copied to an aligned base first."""
    log_a, m, h0 = _rglru_inputs(2, 70, 64, seed=9)
    (aj, at), (mj, mt) = _pair(log_a, dtype), _pair(m, dtype)
    at = torch.zeros(at.numel() + 1, dtype=at.dtype)[1:].copy_(at.reshape(-1)).view(at.shape)
    assert at.data_ptr() % 16 != 0
    h_seq, h_final = _rglru_kernel_emulation(at, mt, torch.from_numpy(h0))
    want_seq, want_final = jax_rglru_ref(aj, mj, jnp.asarray(h0))
    _close(h_seq, want_seq, RGLRU_TOL)
    _close(h_final, want_final, RGLRU_TOL)


def test_rglru_kernel_input_rules():
    """What the CUDA wrapper hands the kernel, checked without a card: log_a
    and m float32 or bfloat16 and the same, h0 any floating type as float32;
    anything else raises TypeError (no plain-version fallback), and a CPU
    tensor is refused before any of it."""
    x = torch.zeros((1, 4, 8))
    h0 = torch.zeros((1, 8))
    for bad in ((x.half(), x.half(), h0), (x, x.bfloat16(), h0), (x.double(), x.double(), h0),
                (x, x, h0.int())):
        with pytest.raises(TypeError):
            lru.kernel_inputs(*bad)
    la, mm, h = lru.kernel_inputs(x.bfloat16(), x.bfloat16(), h0.double())
    assert la.dtype == mm.dtype == torch.bfloat16 and h.dtype == torch.float32
    off = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert off.data_ptr() % 4 == 2 and lru.kernel_inputs(off, off, h0)[0].data_ptr() % 4 == 0
    with pytest.raises(ValueError, match="CUDA"):
        lru.rglru(x.half(), x.half(), h0)
    assert lru.copy_bytes(4096, 4, 0, 512) == 16 and lru.copy_bytes(4096, 2, 0, 0) == 16
    assert lru.copy_bytes(98, 4, 0, 0) == 4 and lru.copy_bytes(100, 2, 0, 0) == 4
    assert lru.copy_bytes(64, 4, 4, 0) == 4


def test_wkv6_kernel_head_sizes_cover_the_reference_sweep():
    """csrc/wkv6.cu is built for every head size tests/test_kernels.py
    sweeps (8, 16, 32) and the full model's 64."""
    assert rwkv6.HEAD_SIZES == (8, 16, 32, 64)
