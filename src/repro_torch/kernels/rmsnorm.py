"""Fused RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` (forward and
backward) and their plain versions.

The forward replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas
kernel). Memory-bound on the H100: one read and one write of the rows; the
kernel gives each row one warp, which holds the row in registers between
the float32 mean square and the scaled write, and moves 16 bytes per load
and store (see the note in the source).

The backward has no Pallas counterpart (the reference takes ``jax.grad``
of its jnp norm): ``rmsnorm_bwd`` gives dx and dscale. It is bound by
memory (x and dy read once, dx written once: 25.2 MB at gemma-2b's
training shape (2048, 2048) in bf16, 7.5 us at 3.35 TB/s). Its kernel
holds each row in the registers of a few warps (a lane holds at most 16
elements of x and 16 of dy), loads x and dy once with 16-byte loads,
reduces the row's two sums by shuffles, writes dx, and keeps its columns'
dscale sums in registers across the rows it runs. dscale is summed in an
order that ``bwd_plan`` fixes from (rows, d) alone: a slot's rows in
order, the block's slots in order, then the blocks' partial rows in order
within ``SUM_RUNS`` runs, the runs in order; so it is bit-identical from
run to run and ``tests/test_torch_rmsnorm_bwd.py`` emulates it on the
CPU. Widths whose rows are not a multiple of 512 bytes or need more than
eight warps, and unaligned tensors, take the block kernel (rows one after
another, the same partition and second pass). ``ops.rmsnorm`` binds
forward and backward in an autograd Function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernels since the last reset (see ``ops.launch_counts``)
launches = 0
bwd_launches = 0

#: most blocks of the backward, each of which writes one float32 partial row
#: of dscale: two a streaming multiprocessor of the H100 (132), one wave
BWD_MAX_BLOCKS = 264
BWD_MAX_D = 16384
#: a block of the backward runs ``slots`` rows side by side, slots * d about
#: this many elements
BWD_SLOT_ELEMS = 4096
#: runs of partial rows the second pass adds side by side (``SUM_WARPS``)
SUM_RUNS = 8
#: elements of x (and of dy) a lane of the warp kernel holds at most: a
#: warp covers at most 512 columns, a wider row is split over up to 8 warps
BWD_LANE_ELEMS = 16
BWD_MAX_WARPS = 8

_fn = None  # the ctypes entry point, resolved at the first launch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """CUDA kernel. x: (..., d) float32/bfloat16 on the card; scale: (d,)
    float32. Returns x's shape and dtype."""
    global launches, _fn
    if not x.is_cuda:
        raise ValueError("rmsnorm: the CUDA kernel takes a CUDA tensor")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale must be float32 ({d},) on {x.device}")
    scale = scale.contiguous()
    code = _build.dtype_code(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    vectorized = int(d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    if _fn is None:
        _fn = _build.lib().rt_rmsnorm
    err = _fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps, code,
              vectorized, _build.stream_arg(x.device))
    _build.check(err, "rmsnorm")
    launches += 1
    return out


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the same function in torch ops."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def _row_columns(d: int) -> int:
    """Columns a warp of the backward's warp kernel covers at width d: the
    largest power of two that divides d, at most 32 lanes x BWD_LANE_ELEMS."""
    return min(32 * BWD_LANE_ELEMS, d & -d)


def bwd_plan(rows: int, d: int):
    """(blocks, rows a block, slots) of the backward for ``rows`` rows of
    width ``d``: ``slots`` rows side by side in a block (slots * d about
    BWD_SLOT_ELEMS, at most BWD_MAX_WARPS warps), each slot taking every
    ``slots``-th row of its block's run; at most BWD_MAX_BLOCKS blocks of
    consecutive rows (a multiple of ``slots`` each), every row covered. A
    function of (rows, d) alone, so the dscale sums' order is the same on
    every card and in both dtypes."""
    row_warps = d // _row_columns(d)
    slots = max(1, min(BWD_SLOT_ELEMS // d, BWD_MAX_WARPS // row_warps))
    groups = -(-rows // slots)
    per = -(-groups // min(groups, BWD_MAX_BLOCKS)) * slots
    return -(-rows // per), per, slots


def bwd_warp_split(d: int, element_size: int):
    """(16-byte packs a lane holds, warps a row) of the backward's warp
    kernel at width ``d``, or None where it takes the block kernel: a warp
    covers ``_row_columns(d)`` columns, at least one 16-byte pack a lane,
    and a row at most BWD_MAX_WARPS warps."""
    cols = _row_columns(d)
    pack_cols = 32 * 16 // element_size
    if cols < pack_cols or d // cols > BWD_MAX_WARPS:
        return None
    return cols // pack_cols, d // cols


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """CUDA kernel. x, dy: (..., d) float32/bfloat16 on the card, one dtype;
    scale: (d,) float32. Returns (dx in x's dtype and shape, dscale (d,)
    float32)."""
    global bwd_launches
    if not (x.is_cuda and dy.device == x.device):
        raise ValueError("rmsnorm_bwd: the CUDA kernel takes CUDA tensors on one device")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"rmsnorm_bwd: scale must be float32 ({d},) on {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {dy.dtype} {tuple(dy.shape)} is not x's "
                         f"{x.dtype} {tuple(x.shape)}")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: width {d} > {BWD_MAX_D}")
    code = _build.dtype_code(x)
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    rows = x.numel() // d
    blocks, per, slots = bwd_plan(rows, d)
    dx = torch.empty_like(x)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    warp = bwd_warp_split(d, x.element_size())
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx, scale))
    split = warp[1] if warp and aligned else 0  # 0: the block kernel
    err = _build.lib().rt_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                      part.data_ptr(), dscale.data_ptr(), rows, d, blocks, per,
                                      slots, split, eps, code, _build.stream_arg(x.device))
    _build.check(err, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """Plain version of the backward: the kernel's formulas in torch ops,
    r = rsqrt(mean(x^2) + eps), g = dy * scale,
    dx = r * g - x * r^3 * mean(g * x), dscale = sum over rows of dy * x * r."""
    d = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, d)
    gf = dy.to(torch.float32).reshape(-1, d)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.to(torch.float32)
    dx = r * gs - xf * (r * r * r) * torch.mean(gs * xf, dim=-1, keepdim=True)
    dscale = torch.sum(gf * xf * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale
