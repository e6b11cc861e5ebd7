"""Shared layers (counterpart of ``repro/models/layers.py``): RMS and layer
norm, rotary embeddings, causal or sliding-window GQA attention for
prefill and for decode against a ring-buffer KV cache (stored in the
activation dtype or in int8 with per-(token, head) float16 scales), an
encoder's not-causal self-attention, the cross-attention of a decoder over
an encoder's memory, and the MLP variants (swiglu / geglu / gelu).

Parameters are plain dicts of tensors with the reference's shapes and
names. Each matrix weight is cast to the activation dtype at use, as the
reference casts it with ``.astype(x.dtype)``: serving stores the matrices
in the activation dtype already (the cast is then a no-op), training keeps
float32 masters; the qkv biases (qwen2.5, whisper) follow the matrices.
Norm scales and biases stay float32 because the norm computes in float32.
The RMS norm, prefill attention and decode attention go through
:mod:`repro_torch.kernels.ops` (CUDA kernels on the card); the layer norm
(no Pallas kernel computes it in the reference), the projections, the
int8 cache's quantization and the MLP are plain torch ops.

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


def norm_init(dim: int, device, kind: str = "rms") -> Params:
    """{"scale"} (ones), and for ``kind="layer"`` {"bias"} (zeros), float32."""
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def norm_axes(kind: str = "rms") -> Dict:
    return {"scale": ("embed",), "bias": ("embed",)} if kind == "layer" else {"scale": ("embed",)}


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rms", eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``norm_apply``: RMS norm (the kernel), or with
    ``kind="layer"`` the layer norm in float32 with the reference's
    arithmetic: the mean, the mean of the squared deviations, then
    (x - mean) * rsqrt(var + eps) * scale + bias, cast back."""
    if kind != "layer":
        return ops.rmsnorm(x, p["scale"], eps)
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


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
#: and of the int8 cache's scales
SCALE_AXES = {"k_scale": ("batch", "seq", "kv_heads"), "v_scale": ("batch", "seq", "kv_heads")}


def cache_axes(cfg) -> Dict:
    return {**CACHE_AXES, **SCALE_AXES} if cfg.kv_cache_dtype == "int8" else dict(CACHE_AXES)


def _proj(x: torch.Tensor, p: Params, w: str, b: str) -> torch.Tensor:
    """x (B, S, d) @ p[w] (d, h, hd) -> (B, S, h, hd), plus the bias p[b]
    where the layer has the qkv biases (qwen2.5, whisper), cast at use."""
    B, S, d = x.shape
    _, h, hd = p[w].shape
    y = (x @ p[w].to(x.dtype).reshape(d, h * hd)).view(B, S, h, hd)
    return y + p[b].to(x.dtype) if b in p else y


def _qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor, rope: bool = True):
    """q, k, v (B, S, heads, hd), the biases added before RoPE; no RoPE
    with ``rope=False`` (learned positions, an encoder)."""
    q, k, v = _proj(x, p, "wq", "bq"), _proj(x, p, "wk", "bk"), _proj(x, p, "wv", "bv")
    if rope and cfg.rope_theta > 0:
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
                      window: int = 0, rules=None, causal: bool = True, rope: bool = True):
    """Causal self-attention over a prompt whose positions are 0..S-1, each
    query seeing the last ``window`` positions when ``window`` > 0; with
    ``causal=False`` every query sees every position (an encoder's). The
    training loss takes y alone: under autograd the attention runs the
    flash kernels' forward and backward (``ops.flash_attention``).

    Returns (y, k, v); k (roped unless ``rope=False``) and v are (B, S, n,
    hd), the numbers the reference's ``_kv_from_prefill`` recomputes for
    the cache (this rank's kv heads under rules)."""
    s, sel, x, p = _split(p, x, cfg, rules)
    q, k, v = _qkv(p, x, cfg, positions, rope)
    out = ops.flash_attention(
        q.transpose(1, 2), _select(k, sel, 2).transpose(1, 2),
        _select(v, sel, 2).transpose(1, 2), causal=causal, window=window
    )  # (B, H, S, hd)
    return _out_proj(p, out.transpose(1, 2), s), k, v


def cross_attention(p: Params, x: torch.Tensor, memory: torch.Tensor, cfg, rules=None,
                    decode: bool = False) -> torch.Tensor:
    """x (B, S, d) attends to every position of an encoder's ``memory`` (B,
    Sm, d): q from x, k and v projected from the memory, with the biases
    and no RoPE (the reference's ``attention_apply(..., memory=...)``,
    which projects the memory again at every decode step, as this does).
    The prefill runs ``flash_attention`` with the memory's own key length,
    not causal; a decode step (S = 1, ``decode=True``) runs
    ``flash_decode`` over the memory's k/v with every slot valid (kpos =
    0..Sm-1 at position Sm - 1): the reference's all-true mask. Under
    rules the heads split as in self-attention."""
    B = x.shape[0]
    s, sel, x, p = _split(p, x, cfg, rules)
    memory = tp.vary(s, memory)
    q = _proj(x, p, "wq", "bq")
    k = _select(_proj(memory, p, "wk", "bk"), sel, 2).transpose(1, 2)  # (B, n, Sm, hd)
    v = _select(_proj(memory, p, "wv", "bv"), sel, 2).transpose(1, 2)
    if decode:
        Sm = memory.shape[1]
        kpos = torch.arange(Sm, dtype=torch.int32, device=x.device).expand(B, Sm).contiguous()
        out = ops.flash_decode(q[:, 0], k, v, kpos, Sm - 1)[:, None]  # (B, 1, H, hd)
    else:
        out = ops.flash_attention(q.transpose(1, 2), k, v, causal=False).transpose(1, 2)
    return _out_proj(p, out, s)


def attention_decode(p: Params, x: torch.Tensor, cfg, cache: Params, pos: int,
                     window: int = 0, rules=None, rope: bool = True):
    """One new token per row at position ``pos`` against the layer's cache
    {"k", "v": (B, W, n, hd), "kpos": (B, W) int32} (int8 k / v with
    {"k_scale", "v_scale": (B, W, n) float16} for an int8 cache), seeing
    the last ``window`` positions when ``window`` > 0.

    The reference returns a new cache from ``dynamic_update_slice``; here
    the token's k/v (quantized first in an int8 cache, as the reference
    quantizes the token before it attends to it) and position are written
    into slot ``pos % W`` in place. The kernel reads the cache in this
    layout through strides; an int8 cache is dequantized whole first."""
    B = x.shape[0]
    s, sel, x, p = _split(p, x, cfg, rules)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, rope)
    slot = pos % cache["k"].shape[1]
    cache["kpos"][:, slot] = pos
    if "k_scale" in cache:
        kv = {}
        for name, t in (("k", k), ("v", v)):
            cache[name][:, slot], cache[f"{name}_scale"][:, slot] = _quantize_kv(t[:, 0])
            kv[name] = _dequantize_kv(_select(cache[name], sel, 2),
                                      _select(cache[f"{name}_scale"], sel, 2), x.dtype)
        ck, cv = kv["k"], kv["v"]
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        ck, cv = _select(cache["k"], sel, 2), _select(cache["v"], sel, 2)
    out = ops.flash_decode(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2), cache["kpos"], pos,
                           window=window)  # (B, H, hd)
    return _out_proj(p, out[:, None], s)


def attention_cache_init(cfg, batch: int, length: int, dtype, device) -> Params:
    """An empty cache: k / v in ``dtype``, or for ``cfg.kv_cache_dtype ==
    "int8"`` int8 k / v and float16 per-(token, head) scales (the
    reference's layout); kpos -1 (empty)."""
    n, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    cache = {
        "k": torch.zeros((batch, length, n, hd), dtype=kv_dtype, device=device),
        "v": torch.zeros((batch, length, n, hd), dtype=kv_dtype, device=device),
        "kpos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }
    if cfg.kv_cache_dtype == "int8":
        for name in SCALE_AXES:
            cache[name] = torch.zeros((batch, length, n), dtype=torch.float16, device=device)
    return cache


def _quantize_kv(x: torch.Tensor):
    """x (..., hd) -> (int8 values, float16 scales (...)), the reference's
    arithmetic: the float32 amax over hd, scale = max(amax, 1e-6) / 127,
    round half to even of x / scale, clipped to +-127."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.float16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]).to(dtype)


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
