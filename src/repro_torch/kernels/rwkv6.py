"""WKV6 (RWKV-6 / Finch): the CUDA kernels ``csrc/wkv6.cu`` (forward) and
``csrc/wkv6_bwd.cu`` (backward), and their plain versions.

Replaces ``src/repro/kernels/rwkv6.py::wkv6`` (the Pallas kernel); the
plain version is the chunked form of ``repro/models/rwkv6.py::wkv6_chunked``
in torch. Both compute the recurrence of ``repro/kernels/ref.py::wkv6_ref``

    y_t = S_t^T r_t + (r_t . (u * k_t)) v_t,   S_{t+1} = diag(exp(w_t)) S_t + k_t v_t^T

over r/k/v/wlog (B, H, S, N), u (H, N) and the float32 state (B, H, N, N),
and return y in r's dtype with the final float32 state. The kernel is
bound by bytes (see the note in the source); it reads r/k/v/wlog through
their strides, so the model passes its (B, S, H, N) projections as views.
A block owns a slab of columns of one (b, h)'s state, a thread an R x C
tile of it (``TILES``), and the block stages ``TILE`` tokens at a time
(:func:`launch_plan`).

The backward (:func:`wkv6_bwd`) takes the forward's inputs, dy and the
final state's gradient dS_T and returns dr, dk, dv, dwlog, du and dstate.
It cuts the sequence into chunks of ``BWD_CHUNK`` tokens that run at once:
each chunk's contribution to the state's gradient, a scan over the chunks
for its value at their ends, a pass over the state in token order for dr
(which keeps the state at each chunk's end), a pass per chunk in reverse
order for dk, dwlog, dv and dstate, and du's sum (:func:`bwd_plan`). Its plain version
(:func:`wkv6_bwd_ref`) is autograd through :func:`wkv6_ref` in float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: calls of the CUDA forward and backward since the last reset (see
#: ``ops.launch_counts``)
launches = 0
bwd_launches = 0

#: head sizes csrc/wkv6.cu and wkv6_bwd.cu instantiate: the reduced and the full rwkv6-1.6b's
#: (16, 64) and the others tests/test_kernels.py sweeps (8, 32)
HEAD_SIZES = (8, 16, 32, 64)
_CHUNK = 64  # tokens per chunk of the plain version

#: tokens per staged tile of csrc/wkv6.cu
TILE = 32
#: csrc/wkv6.cuh's Tile<N>: per head size, the rows R and columns C of the
#: state a thread carries and the columns JC of a block's slab (the
#: backward's row passes take it transposed)
TILES = {8: (2, 1, 8), 16: (4, 1, 16), 32: (4, 4, 32), 64: (4, 4, 16)}

#: tokens a chunk of the backward, csrc/wkv6_bwd.cu's CHUNK (a multiple of
#: BWD_ROW_TILE); its chunks run at once
BWD_CHUNK = 128
#: csrc/wkv6_bwd.cu's tokens per staged tile of the row passes (TR) and of
#: the chunk contributions (CT), and threads a block of the scan and of du's
#: sum
BWD_ROW_TILE = 16
BWD_CHUNK_TILE = 32
BWD_FLAT_THREADS = 256
#: the backward's launches, in the order they run
BWD_LAUNCHES = ("chunk", "scan", "rows 1", "rows 2", "du")


def launch_plan(B: int, H: int, N: int) -> tuple:
    """(blocks, threads per block, static shared bytes) of the kernel's
    launch for B x H heads of size N: a block per slab of JC columns of a
    (b, h), a thread per R x C tile of the slab; its tile holds TILE tokens
    of r, k and exp(w) at N wide, of the bonus products at N + 1 wide, of v
    at JC wide, and the bonus's parts (one per TILE threads) per token."""
    R, C, JC = TILES[N]
    threads = JC // C * (N // R)
    smem = 4 * TILE * (3 * N + (N + 1) + JC + threads // TILE)
    return B * H * (N // JC), threads, smem


def bwd_plan(B: int, H: int, S: int, N: int) -> dict:
    """The backward's plan for B x H heads of size N over S tokens in chunks
    of ``BWD_CHUNK`` tokens, as csrc/wkv6_bwd.cu makes it: ``chunks``,
    ``launches`` {name: (blocks, threads per block, static shared bytes)} in
    BWD_LAUNCHES order (the chunk contributions and the scan have 0 blocks
    with one chunk), ``dynamic``,
    the second row pass's dynamic shared bytes (its warps' column sums), and
    ``scratch``, the float32 elements of its scratch: A' (B, H, S, N), the
    reverse chunk states and the states at the chunks' ends (B, H, NC, N,
    N) each, the chunk decays and the du partials (B, H, NC, N) each."""
    nc = -(-S // BWD_CHUNK)
    bh = B * H
    r_f, c_f, jc = TILES[N]
    # the row passes take the forward's tile transposed: the first a slab of
    # jc rows a block over the whole sequence, the second all N rows (its
    # column sums run over every row) a chunk
    threads1, threads2 = jc // c_f * (N // r_f), N // c_f * (N // r_f)
    tr, pb, ct, flat = BWD_ROW_TILE, N + 4, BWD_CHUNK_TILE, BWD_FLAT_THREADS

    def rows(jr):  # sa and sbv one token more than the tile, sm, sw, scv, 2 token scalars
        return 4 * ((3 * tr + 1) * jr + (2 * tr + 1) * pb + 2 * tr)

    ti = 4 if N >= 32 else N // 8
    launches = {
        # w by row, then r and dy, and each row's sum of w so far
        "chunk": (bh * (nc - 1), (N // ti) ** 2, 4 * (N * (ct + 1) + 2 * ct * N + N)),
        "scan": (-(-bh * N * N // 4 // flat) if nc > 1 else 0, flat, 0),
        "rows 1": (bh * (N // jc), threads1, rows(jc)),
        # pass 2 adds A' of the tile, two more token scalars and u
        "rows 2": (bh * nc, threads2, rows(N) + 4 * (tr * N + 2 * tr + N)),
        "du": (-(-H * N // flat), flat, 0),
    }
    return dict(chunks=nc, launches=launches,
                dynamic=4 * threads2 // 32 * tr * N,
                scratch=bh * (S + 2 * nc * N + 2 * nc) * N)


def device_bwd_plan(dtype: torch.dtype, B: int, H: int, S: int, N: int) -> dict:
    """The built backward's own plan on the current CUDA device for a call
    at (B, H, S, N): {launch: (blocks, threads, static shared bytes, blocks
    resident on one SM)} in BWD_LAUNCHES order."""
    out = (ctypes.c_int * (4 * len(BWD_LAUNCHES)))()
    err = _build.lib().rt_wkv6_bwd_plan(_build.DTYPE_CODES[str(dtype)], N, B, H, S, out)
    _build.check(err, "wkv6_bwd plan")
    return {name: tuple(out[4 * i:4 * i + 4]) for i, name in enumerate(BWD_LAUNCHES)}


def device_plan(dtype: torch.dtype, N: int) -> dict:
    """The built kernel's own plan on the current CUDA device, for
    (dtype, N): threads, static shared bytes, blocks per (b, h) and blocks
    resident on one SM."""
    out = (ctypes.c_int * 4)()
    err = _build.lib().rt_wkv6_plan(_build.DTYPE_CODES[str(dtype)], N, out)
    _build.check(err, "wkv6 plan")
    return dict(threads=out[0], smem=out[1], slabs=out[2], per_sm=out[3])


def _check(r, k, v, wlog, u, state):
    B, H, S, N = r.shape
    if k.shape != r.shape or v.shape != r.shape or wlog.shape != r.shape:
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"wlog {tuple(wlog.shape)} must all be (B, H, S, N)")
    if u.shape != (H, N) or state.shape != (B, H, N, N):
        raise ValueError(f"wkv6: u {tuple(u.shape)} must be {(H, N)} and state "
                         f"{tuple(state.shape)} must be {(B, H, N, N)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError("wkv6: r, k and v must share a dtype")
    return B, H, S, N


def _check_cuda(name, *ts):
    dev = ts[0].device
    if not (ts[0].is_cuda and all(t.device == dev for t in ts)):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors on one device")


def wkv6(r, k, v, wlog, u, state):
    """CUDA kernel. r/k/v: (B, H, S, N) float32 or bfloat16 (any strides with
    a contiguous N axis); wlog: the same shape in float32 (log decay <= 0);
    u: (H, N) and state: (B, H, N, N) float32. Returns (y, final state):
    y (B, H, S, N) in r's dtype, as a view of a (B, S, H, N) buffer, which
    the model's group norm reads without a copy; the state (B, H, N, N)."""
    global launches
    _check_cuda("wkv6", r, k, v, wlog, u, state)
    dev = r.device
    B, H, S, N = _check(r, k, v, wlog, u, state)
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {N} not in {HEAD_SIZES}")
    if not (wlog.dtype == u.dtype == state.dtype == torch.float32):
        raise TypeError("wkv6: wlog, u and state must be float32")
    for name, t in (("r", r), ("k", k), ("v", v), ("wlog", wlog)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name}'s head axis must have stride 1")
    u, state = u.contiguous(), state.contiguous()
    y = torch.empty((B, S, H, N), dtype=r.dtype, device=dev).transpose(1, 2)
    state_out = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    strides = _build.strides_arg(*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *wlog.stride()[:3], *y.stride()[:3])
    err = _build.lib().rt_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), state_out.data_ptr(), B, H, S, N, strides,
        _build.dtype_code(r), _build.stream_arg(dev),
    )
    _build.check(err, "wkv6")
    launches += 1
    return y, state_out


def wkv6_ref(r, k, v, wlog, u, state):
    """Plain version: the chunked form. Within a chunk of L <= _CHUNK tokens
    the decay from token s to token t > s is exp(ld[t-1] - ld[s]) with ld the
    inclusive cumulative log decay, masked to s < t before the exp (every
    exponent taken is <= 0); the state carries from chunk to chunk. The
    last chunk may be short, so any S works."""
    B, H, S, N = _check(r, k, v, wlog, u, state)
    f32 = torch.float32
    s_state = state.to(f32)
    uf = u.to(f32)[None, :, None, :]  # (1, H, 1, N)
    tri = torch.tril(torch.ones((_CHUNK, _CHUNK), dtype=torch.bool, device=r.device), -1)
    ys = []
    for t0 in range(0, S, _CHUNK):
        L = min(_CHUNK, S - t0)
        rb, kb, vb, wb = (t[:, :, t0:t0 + L].to(f32) for t in (r, k, v, wlog))  # (B,H,L,N)
        ld = torch.cumsum(wb, dim=2)
        ldm1 = ld - wb  # exclusive cumulative log decay
        pair = ldm1[:, :, :, None, :] - ld[:, :, None, :, :]  # (B, H, Lt, Ls, N)
        A = torch.exp(pair.masked_fill(~tri[:L, :L, None], float("-inf")))
        w_ts = (rb[:, :, :, None, :] * kb[:, :, None, :, :] * A).sum(-1)  # (B, H, Lt, Ls)
        y = w_ts @ vb
        y = y + (rb * kb * uf).sum(-1, keepdim=True) * vb  # the diagonal bonus u
        y = y + (rb * torch.exp(ldm1)) @ s_state  # the carried state
        kscale = kb * torch.exp(ld[:, :, -1:] - ld)
        s_state = s_state * torch.exp(ld[:, :, -1])[..., None] + kscale.transpose(-1, -2) @ vb
        ys.append(y)
    return torch.cat(ys, dim=2).to(r.dtype), s_state


def _like_y(shape, dtype, device):
    """An empty (B, H, S, N) tensor laid out as (B, S, H, N), as the forward's y."""
    B, H, S, N = shape
    return torch.empty((B, S, H, N), dtype=dtype, device=device).transpose(1, 2)


def wkv6_bwd(r, k, v, wlog, u, state, dy, dstate_T):
    """CUDA backward of :func:`wkv6`. r/k/v/wlog/u/state as the forward
    takes them; dy: y's gradient in r's dtype (any strides; a head axis
    that is not contiguous is copied); dstate_T: the final state's gradient
    (B, H, N, N) float32. Returns (dr, dk, dv) in r's dtype, dwlog float32,
    each (B, H, S, N) as views of (B, S, H, N) buffers, du (H, N) and
    dstate (B, H, N, N) float32. Five launches over chunks of ``BWD_CHUNK``
    tokens (:func:`bwd_plan`), no atomics."""
    global bwd_launches
    _check_cuda("wkv6_bwd", r, k, v, wlog, u, state, dy, dstate_T)
    dev = r.device
    B, H, S, N = _check(r, k, v, wlog, u, state)
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6_bwd: head size {N} not in {HEAD_SIZES}")
    if dy.shape != r.shape or dstate_T.shape != state.shape:
        raise ValueError(f"wkv6_bwd: dy {tuple(dy.shape)} must be {tuple(r.shape)} and "
                         f"dstate_T {tuple(dstate_T.shape)} {tuple(state.shape)}")
    if dy.dtype != r.dtype:
        raise TypeError("wkv6_bwd: dy must be in r's dtype")
    if not (wlog.dtype == u.dtype == state.dtype == dstate_T.dtype == torch.float32):
        raise TypeError("wkv6_bwd: wlog, u, state and dstate_T must be float32")
    for name, t in (("r", r), ("k", k), ("v", v), ("wlog", wlog)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6_bwd: {name}'s head axis must have stride 1")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    u, state, dstate_T = u.contiguous(), state.contiguous(), dstate_T.contiguous()
    dr, dk, dv = (_like_y(r.shape, r.dtype, dev) for _ in range(3))
    dwlog = _like_y(r.shape, torch.float32, dev)
    du = torch.empty((H, N), dtype=torch.float32, device=dev)
    dstate = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    plan = bwd_plan(B, H, S, N)
    scratch = torch.empty((plan["scratch"],), dtype=torch.float32, device=dev)
    views = (r, k, v, dy, wlog, dr, dk, dv, dwlog)
    strides = _build.strides_arg(*(s for t in views for s in t.stride()[:3]))
    err = _build.lib().rt_wkv6_bwd(
        *(t.data_ptr() for t in (r, k, v, dy, wlog, u, state, dstate_T, dr, dk, dv, dwlog, du,
                                 dstate, scratch)),
        B, H, S, N, strides, _build.dtype_code(r), _build.stream_arg(dev),
    )
    _build.check(err, "wkv6_bwd")
    bwd_launches += 1
    return dr, dk, dv, dwlog, du, dstate


def wkv6_bwd_ref(r, k, v, wlog, u, state, dy, dstate_T):
    """Plain version of :func:`wkv6_bwd`: ``torch.autograd.grad`` through
    :func:`wkv6_ref` in float32, the route the reference's gradient takes
    (``jax.grad`` of the chunked form). The same outputs and dtypes."""
    f32 = torch.float32
    with torch.enable_grad():
        leaves = [t.detach().to(f32).requires_grad_() for t in (r, k, v, wlog, u, state)]
        y, s_out = wkv6_ref(*leaves)
        grads = torch.autograd.grad((y, s_out), leaves, (dy.to(f32), dstate_T.to(f32)))
    dr, dk, dv, dwlog, du, dstate = grads
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dwlog, du, dstate
