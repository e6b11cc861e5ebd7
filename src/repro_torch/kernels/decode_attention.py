"""Flash decode: the CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.

Replaces ``src/repro/kernels/decode_attention.py::flash_decode`` (the
Pallas kernel); the plain version is its ``flash_decode_ref`` in torch. One
query token per row against a ring-buffer KV cache; a slot is valid iff
``kpos >= 0 & kpos <= pos`` (and ``kpos > pos - window`` when windowed).
A row with no valid slot gives the mean of V over all slots, as the Pallas
kernel does. The kernel reads k/v through their strides, so the model
passes its ``(B, W, n, hd)`` cache as a ``(B, n, W, hd)`` view and nothing
is copied.

The kernel is one launch: each block stages one chunk of the cache in
shared memory with 16-byte ``cp.async`` copies and keeps its float32
partial there; each cluster of 8 blocks combines its partials through
distributed shared memory into scratch, and the cluster that finishes a
row last (a ticket on an int32 counter) combines the row's clusters. The
counters and the scratch are allocated once per (device, stream) and
reused: calls on one stream are ordered by it, and calls on two streams
get two sets.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30

#: launches of the CUDA kernel since the last reset (see ``ops.launch_counts``)
launches = 0

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
MAX_GROUP = 16  # query heads per KV head the kernel serves from one block
MIN_CHUNK = 8  # cache slots per block: below this a block's fixed costs dominate
MAX_CHUNK = 64  # the kernel's shared-memory tile (csrc/decode_attention.cu)
CLUSTER = 8  # blocks per thread block cluster (csrc/decode_attention.cu)


def _check(q, k, v, kpos):
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    if k.shape != (B, K, S, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,H,hd)/(B,K,S,hd) with H % K == 0")
    if kpos.shape != (B, S) or kpos.dtype != torch.int32:
        raise ValueError(f"flash_decode: kpos must be int32 {(B, S)}, got "
                         f"{kpos.dtype} {tuple(kpos.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_decode: q, k and v must share a dtype")
    return B, H, K, S, hd


@functools.lru_cache(maxsize=None)
def decode_plan(S: int, rows: int, sms: int):
    """The kernel's grid along the cache: ``(chunk, n_chunks)``.

    ``rows`` blocks (one per batch row and KV head) are too few to fill
    ``sms`` SMs, so the cache axis is cut into ``n_chunks = ceil(S /
    chunk)`` chunks, one block each, in clusters of CLUSTER blocks: as many
    clusters as give every SM a block, with the chunks spread evenly over
    them, where S allows. A chunk holds MIN_CHUNK to MAX_CHUNK slots. The
    kernel pads each row's blocks with empty ones to a whole number of
    clusters."""
    want = -(-sms // rows)  # blocks per row for a block per SM
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, -(-S // (-(-want // CLUSTER) * CLUSTER))))
    while chunk > MIN_CHUNK and -(-S // chunk) < want:
        chunk -= 1
    return chunk, -(-S // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_workspace = {}  # (device index, raw stream) -> (int32 counters, float32 scratch)
_fn = None  # the ctypes entry point, resolved at the first launch


def _buffers(dev, stream: int, n_rows: int, n_floats: int):
    """The counters (zero between calls: the kernel resets them) and
    scratch of one stream on the device, grown when a call needs more."""
    key = (dev.index, stream)
    counters, scratch = _workspace.get(key, (None, None))
    if counters is None or counters.numel() < n_rows:
        counters = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < n_floats:
        scratch = torch.empty((n_floats,), dtype=torch.float32, device=dev)
    _workspace[key] = (counters, scratch)
    return counters, scratch


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0) -> torch.Tensor:
    """CUDA kernel. q: (B, H, hd); k/v: (B, K, S, hd) (any strides with a
    contiguous head_dim; q, k and v 16-byte aligned); kpos: (B, S) int32
    (-1 = empty); pos: the decode position, a Python int. Returns (B, H, hd)
    in q's dtype."""
    global launches, _fn
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, kpos))):
        raise ValueError("flash_decode: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, hd = _check(q, k, v, kpos)
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS} or "
                         f"{H // K} query heads per KV head > {MAX_GROUP}")
    size = k.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_decode: {name}'s head_dim axis must have stride 1")
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:-1]):
            raise ValueError(f"flash_decode: {name} needs a 16-byte aligned base and "
                             f"strides of 16 bytes (16-byte loads), got {t.stride()}")
    g = H // K
    chunk, n_chunks = decode_plan(S, B * K, _sm_count(dev.index))
    n_clusters = -(-n_chunks // CLUSTER)
    stream = _build.stream_arg(dev)
    # per (row, cluster): g x hd accumulators and each rank's (max, sum) of g heads
    counters, scratch = _buffers(dev, stream, B * K * CLUSTER,
                                 B * K * n_clusters * g * (hd + 2 * CLUSTER))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    strides = _build.strides_arg(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
                                 *kpos.stride(), *out.stride()[:2])
    if _fn is None:
        _fn = _build.lib().rt_flash_decode
    err = _fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), B, H, K, S, hd, chunk, strides,
        int(pos), int(window), 1.0 / math.sqrt(hd), _build.dtype_code(q), stream,
    )
    _build.check(err, "flash_decode")
    launches += 1
    return out


def flash_decode_ref(q, k, v, kpos, pos: int, *, window: int = 0) -> torch.Tensor:
    """Plain version: masked full softmax over the cache."""
    B, H, K, S, hd = _check(q, k, v, kpos)
    g = H // K
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)  # (B,H,S,hd)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhd,bhsd->bhs", q.to(torch.float32), kk) / math.sqrt(hd)
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    s = torch.where(valid[:, None, :], s,
                    torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vv).to(q.dtype)
