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
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """out: (B, S, H, hd) -> (B, S, d)."""
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ p["wo"].to(out.dtype).reshape(H * hd, -1)


def attention_prefill(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                      window: int = 0):
    """Causal self-attention over a prompt whose positions are 0..S-1, each
    query seeing the last ``window`` positions when ``window`` > 0.

    Returns (y, k, v); k (roped) and v are (B, S, n, hd), the numbers the
    reference's ``_kv_from_prefill`` recomputes for the cache."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, window=window
    )  # (B, H, S, hd)
    return _out_proj(p, out.transpose(1, 2)), k, v


def attention_train(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """``attention_prefill`` for the training loss: the output only, no
    cache. Under autograd the attention runs the flash kernels' forward and
    backward (``ops.flash_attention``)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, window=window
    )
    return _out_proj(p, out.transpose(1, 2))


def attention_decode(p: Params, x: torch.Tensor, cfg, cache: Params, pos: int,
                     window: int = 0):
    """One new token per row at position ``pos`` against the layer's cache
    {"k", "v": (B, W, n, hd), "kpos": (B, W) int32}, seeing the last
    ``window`` positions when ``window`` > 0.

    The reference returns a new cache from ``dynamic_update_slice``; here
    the token's k/v and position are written into slot ``pos % W`` in
    place, and the kernel reads the cache in this layout through strides."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][:, slot] = pos
    out = ops.flash_decode(
        q[:, 0], cache["k"].transpose(1, 2), cache["v"].transpose(1, 2), cache["kpos"], pos,
        window=window,
    )  # (B, H, hd)
    return _out_proj(p, out[:, None])


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


def mlp_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    if "wg" in p:
        act = F.silu if cfg.mlp == "swiglu" else gelu
        return (act(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))) @ p["wo"].to(dt)
    return gelu(x @ p["wi"].to(dt) + p["bi"].to(dt)) @ p["wo"].to(dt) + p["bo"].to(dt)
