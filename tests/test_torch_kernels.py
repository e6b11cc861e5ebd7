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
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models.layers import _sdpa
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = 3e-5


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


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (3, 100)])
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


@pytest.mark.parametrize("case", ["empty_slots", "window", "wrapped_ring"])
def test_flash_decode_plain_matches_pallas(case):
    B, H, K, S, hd = 2, 4, 2, 128, 32
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    pos, window = {"empty_slots": (S - 10, 0), "window": (S - 10, 32),
                   "wrapped_ring": (3 * S + 17, 0)}[case]
    kpos = _ring_kpos(B, S, pos)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
                            jnp.int32(pos), window=window, block_k=32, interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(kpos), pos, window=window)
    _close(got, want, DECODE_TOL)


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
