"""Shared layers (counterpart of ``repro/models/layers.py``): RMS norm,
rotary embeddings, causal or sliding-window GQA attention for prefill and
for decode against a ring-buffer KV cache, and the MLP variants (swiglu /
geglu / gelu).

Parameters are plain dicts of tensors with the reference's shapes and
names. Each matrix weight is cast to the activation dtype at use, as the
reference casts it with ``.astype(x.dtype)``: serving stores the matrices
in the activation dtype already (the cast is then a no-op), training keeps
float32 masters; the qkv biases (qwen2.5) follow the matrices. Norm scales
stay float32 because the norm multiplies in float32.
The norm, prefill attention and decode attention go through
:mod:`repro_torch.kernels.ops` (CUDA kernels on the card); the projections
and the MLP are plain matrix products.

Under ``rules`` each function runs on this rank's shards
(:mod:`repro_torch.sharding.tp`). Attention: q (and k / v where "kv_heads"
splits too) hold this rank's heads, ``wo`` their rows, and the output is a
part summed over "model". Where the heads split and the kv heads do not,
every rank computes all kv heads (the cache is whole, as the rules lay it)
and hands the kernels the ones its q heads read (:func:`kv_heads`). The MLP
is column-split (``wg`` / ``wu`` / ``wi``) then row-split (``wo``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import tp

INIT_STD = 0.02

Params = Dict[str, torch.Tensor]


def _normal(gen, shape, std, device, dtype):
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def norm_init(dim: int, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


NORM_AXES = {"scale": ("embed",)}


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm (the reference's ``norm_apply(..., kind="rms")``)."""
    return ops.rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S). Rotates split halves, with the
    frequencies and angles in float32, as the reference does."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[..., None, :]  # (B, S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, device, dtype) -> Params:
    """The projections, and with ``cfg.qkv_bias`` the q/k/v biases bq (H,
    hd), bk and bv (n, hd), zeros as the reference initialises them."""
    d, H, n, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": _normal(gen, (d, H, hd), INIT_STD, device, dtype),
        "wk": _normal(gen, (d, n, hd), INIT_STD, device, dtype),
        "wv": _normal(gen, (d, n, hd), INIT_STD, device, dtype),
        "wo": _normal(gen, (H, hd, d), INIT_STD, device, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", n), ("bv", n)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def attention_axes(cfg) -> Dict:
    """The logical axes of ``attention_init``'s leaves (the reference's)."""
    ax = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
          "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        ax.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                  bv=("kv_heads", "head_dim"))
    return ax


#: the logical axes of an attention layer's decode cache
CACHE_AXES = {"k": ("batch", "seq", "kv_heads", "head_dim"),
              "v": ("batch", "seq", "kv_heads", "head_dim"), "kpos": ("batch", "seq")}


def _qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    B, S, d = x.shape
    _, H, hd = p["wq"].shape
    n = p["wk"].shape[1]
    q = (x @ p["wq"].to(x.dtype).reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(d, n * hd)).view(B, S, n, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(d, n * hd)).view(B, S, n, hd)
    if "bq" in p:  # qkv bias (qwen2.5): added before RoPE, cast at use
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.rope_theta > 0:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


KVSelect = Union[None, Tuple[int, int], torch.Tensor]


def kv_heads(s: Optional[tp.Split], n_local: int, cfg) -> KVSelect:
    """The kv heads that this rank's ``n_local`` q heads read when the heads
    split over "model" and the kv heads do not: None when the rank's kv
    heads are its q heads' already (nothing split, or both split alike);
    else (first, count) of a contiguous run, each kv head serving the same
    number of local q heads (the kernels' group is then local H / count);
    else, when the run is uneven, one kv head a q head as an index tensor
    (group 1)."""
    if s is None:
        return None
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = tp.offset(s, n_local)
    if n_local % g == 0:
        return h0 // g, n_local // g
    if g % n_local == 0:
        return h0 // g, 1
    return torch.arange(h0, h0 + n_local) // g


def _select(t: torch.Tensor, sel: KVSelect, dim: int) -> torch.Tensor:
    """The selected kv heads along ``dim``: a view for a contiguous run (its
    strides are the whole tensor's and its base moves by whole heads, so it
    keeps the kernels' 16-byte alignment and stride rules), a gathered
    copy for an index tensor."""
    if sel is None:
        return t
    if isinstance(sel, tuple):
        return t.narrow(dim, *sel)
    return t.index_select(dim, sel.to(t.device))


def _split(p: Params, x: torch.Tensor, cfg, rules):
    """(the heads' split, the kv selection, the block's input, its leaves):
    the input and the whole kv leaves pass ``tp.vary`` where the heads
    split."""
    s = tp.split(rules, p["wq"].shape[1], cfg.n_heads)
    if s is None:
        return None, None, x, p
    if p["wk"].shape[1] != cfg.n_kv_heads:  # kv heads split alike: all leaves local
        return s, None, tp.vary(s, x), p
    whole = {k: tp.vary(s, p[k]) for k in ("wk", "wv", "bk", "bv") if k in p}
    return s, kv_heads(s, p["wq"].shape[1], cfg), tp.vary(s, x), {**p, **whole}


def _out_proj(p: Params, out: torch.Tensor, s: Optional[tp.Split] = None) -> torch.Tensor:
    """out: (B, S, H, hd) -> (B, S, d), summed over "model" when split."""
    B, S, H, hd = out.shape
    return tp.psum(s, out.reshape(B, S, H * hd) @ p["wo"].to(out.dtype).reshape(H * hd, -1))


def attention_prefill(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                      window: int = 0, rules=None):
    """Causal self-attention over a prompt whose positions are 0..S-1, each
    query seeing the last ``window`` positions when ``window`` > 0.

    Returns (y, k, v); k (roped) and v are (B, S, n, hd), the numbers the
    reference's ``_kv_from_prefill`` recomputes for the cache (this rank's
    kv heads under rules)."""
    s, sel, x, p = _split(p, x, cfg, rules)
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2), _select(k, sel, 2).transpose(1, 2),
        _select(v, sel, 2).transpose(1, 2), causal=True, window=window
    )  # (B, H, S, hd)
    return _out_proj(p, out.transpose(1, 2), s), k, v


def attention_train(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window: int = 0, rules=None) -> torch.Tensor:
    """``attention_prefill`` for the training loss: the output only, no
    cache. Under autograd the attention runs the flash kernels' forward and
    backward (``ops.flash_attention``)."""
    s, sel, x, p = _split(p, x, cfg, rules)
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2), _select(k, sel, 2).transpose(1, 2),
        _select(v, sel, 2).transpose(1, 2), causal=True, window=window
    )
    return _out_proj(p, out.transpose(1, 2), s)


def attention_decode(p: Params, x: torch.Tensor, cfg, cache: Params, pos: int,
                     window: int = 0, rules=None):
    """One new token per row at position ``pos`` against the layer's cache
    {"k", "v": (B, W, n, hd), "kpos": (B, W) int32}, seeing the last
    ``window`` positions when ``window`` > 0.

    The reference returns a new cache from ``dynamic_update_slice``; here
    the token's k/v and position are written into slot ``pos % W`` in
    place, and the kernel reads the cache in this layout through strides."""
    B = x.shape[0]
    s, sel, x, p = _split(p, x, cfg, rules)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][:, slot] = pos
    out = ops.flash_decode(
        q[:, 0], _select(cache["k"], sel, 2).transpose(1, 2),
        _select(cache["v"], sel, 2).transpose(1, 2), cache["kpos"], pos, window=window,
    )  # (B, H, hd)
    return _out_proj(p, out[:, None], s)


def attention_cache_init(cfg, batch: int, length: int, dtype, device) -> Params:
    n, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, length, n, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n, hd), dtype=dtype, device=device),
        "kpos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

gelu = functools.partial(F.gelu, approximate="tanh")  # jax.nn.gelu's default


def mlp_init(gen, cfg, device, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wg": _normal(gen, (d, f), INIT_STD, device, dtype),
            "wu": _normal(gen, (d, f), INIT_STD, device, dtype),
            "wo": _normal(gen, (f, d), INIT_STD, device, dtype),
        }
    return {
        "wi": _normal(gen, (d, f), INIT_STD, device, dtype),
        "bi": torch.zeros((f,), dtype=dtype, device=device),
        "wo": _normal(gen, (f, d), INIT_STD, device, dtype),
        "bo": torch.zeros((d,), dtype=dtype, device=device),
    }


def mlp_axes(cfg) -> Dict:
    """The logical axes of ``mlp_init``'s leaves (the reference's)."""
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "bi": ("mlp",), "wo": ("mlp", "embed"), "bo": ("embed",)}


def mlp_apply(p: Params, x: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    """The MLP; under rules on this rank's columns of the "mlp" dim, its
    part summed over "model" (``bo`` added once, after the sum)."""
    dt = x.dtype
    s = tp.split(rules, p["wo"].shape[0], cfg.d_ff)
    x = tp.vary(s, x)
    if "wg" in p:
        act = F.silu if cfg.mlp == "swiglu" else gelu
        return tp.psum(s, (act(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))) @ p["wo"].to(dt))
    return tp.psum(s, gelu(x @ p["wi"].to(dt) + p["bi"].to(dt)) @ p["wo"].to(dt)) + p["bo"].to(dt)
