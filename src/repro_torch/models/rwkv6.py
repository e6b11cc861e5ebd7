"""RWKV-6 (Finch) time-mix and channel-mix layers (counterpart of
``repro/models/rwkv6.py``).

The prefill's WKV6 recurrence goes through :func:`repro_torch.kernels.ops.wkv6`
(the CUDA kernel on the card); the one-token decode step is plain torch,
as the reference's ``wkv6_step`` is plain jnp. As in the reference, the
ddlerp token-shift LoRAs for r/k/v/g are static per-channel lerp weights
and the decay LoRA (w0 + tanh(x A) B) is kept.

Parameter dtypes follow the reference's use: ``w0``, ``u``, ``ln_scale``
and ``ln_bias`` enter float32 arithmetic uncast, so they stay float32;
every other weight is cast to the activation dtype at use, as the
reference casts it with ``.astype(x.dtype)``: serving stores it in that
dtype already (the cast is then a no-op), training keeps float32 masters.
Under autograd the prefill's wkv6 runs the CUDA forward and backward
kernels on the card (``ops.wkv6``).

Under ``rules`` (:mod:`repro_torch.sharding.tp`) the time-mix runs this
rank's heads: ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``u`` hold them, the wkv
state and the per-head group norm are local, and of the whole leaves each
rank uses its channels: the columns of ``wB`` and the entries of ``w0``,
``ln_scale`` and ``ln_bias``, the rows of ``wo``, whose output is a part
summed over "model". The whole leaves and the block's input pass
``tp.vary``, so that each gets its gradient summed over the ranks. The
channel-mix's ``wk`` is column-split and ``wv`` row-split; ``wr`` stays
whole and every rank computes its gate alike.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import tp

DECAY_LORA = 64
GROUP_NORM_EPS = 1e-5

#: the time-mix leaves kept in float32, by ``timemix_init`` and by ``convert``
F32_KEYS = ("w0", "u", "ln_scale", "ln_bias")

Params = Dict[str, torch.Tensor]


def _const(shape, value: float, device, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


#: the logical axes of the time-mix's and channel-mix's leaves (the
#: reference's) and of an rwkv layer's decode cache
TIMEMIX_AXES = {**{f"mu_{c}": ("embed",) for c in "rkvgw"}, "w0": ("embed",),
                "wA": ("embed", None), "wB": (None, "embed"), "u": ("heads", "head_dim"),
                **{w: ("embed", "heads", "head_dim") for w in ("wr", "wk", "wv", "wg")},
                "ln_scale": ("embed",), "ln_bias": ("embed",), "wo": ("embed", "embed")}
CHANNELMIX_AXES = {"mu_k": ("embed",), "mu_r": ("embed",), "wk": ("embed", "mlp"),
                   "wv": ("mlp", "embed"), "wr": ("embed", "embed")}
CACHE_AXES = {"wkv": ("batch", "heads", "head_dim", None), "shift_t": ("batch", "embed"),
              "shift_c": ("batch", "embed")}


def timemix_init(gen, cfg, device, dtype) -> Params:
    d, H, N = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim

    def dt(name):
        return torch.float32 if name in F32_KEYS else dtype

    p = {f"mu_{c}": _const((d,), 0.5, device, dtype) for c in "rkvgw"}
    p.update({
        "w0": _const((d,), -6.0, device, dt("w0")),  # exp(-exp(-6)) ~ 0.9975
        "wA": L._normal(gen, (d, DECAY_LORA), 0.01, device, dt("wA")),
        "wB": L._normal(gen, (DECAY_LORA, d), 0.01, device, dt("wB")),
        "u": _const((H, N), 0.0, device, dt("u")),
        **{w: L._normal(gen, (d, H, N), L.INIT_STD, device, dt(w))
           for w in ("wr", "wk", "wv", "wg")},
        "ln_scale": _const((d,), 1.0, device, dt("ln_scale")),
        "ln_bias": _const((d,), 0.0, device, dt("ln_bias")),
        "wo": L._normal(gen, (d, d), L.INIT_STD, device, dt("wo")),
    })
    return p


def channelmix_init(gen, cfg, device, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": _const((d,), 0.5, device, dtype),
        "mu_r": _const((d,), 0.5, device, dtype),
        "wk": L._normal(gen, (d, f), L.INIT_STD, device, dtype),
        "wv": L._normal(gen, (f, d), L.INIT_STD, device, dtype),
        "wr": L._normal(gen, (d, d), L.INIT_STD, device, dtype),
    }


def _shifted(x: torch.Tensor, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """The previous token of every position: ``shift`` (B, d), the last
    token of the previous call (zeros for a fresh sequence), then x[:, :-1]."""
    if shift is None:
        shift = torch.zeros_like(x[:, 0])
    return torch.cat([shift[:, None], x[:, :-1]], dim=1)


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def wkv6_step(r, k, v, wlog, u, state):
    """Single-token decode. r/k/v/wlog: (B, H, N); state: (B, H, N, N) float32.
    Returns (y (B, H, N) in r's dtype, the new state)."""
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, wlog))
    uk = u.to(torch.float32)[None] * kf
    y = torch.einsum("bhn,bhnm->bhm", rf, state) + (rf * uk).sum(-1, keepdim=True) * vf
    state = state * torch.exp(wf)[..., None] + kf[..., None] * vf[..., None, :]
    return y.to(r.dtype), state


def timemix_apply(p: Params, x: torch.Tensor, cfg, shift: Optional[torch.Tensor] = None,
                  wkv_state: Optional[torch.Tensor] = None, decode: bool = False,
                  rules=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out (B, S, d), x[:, -1] as the next shift, the
    wkv state (B, H, N, N) float32; this rank's H heads under rules)."""
    B, S, d = x.shape
    H, N = p["wr"].shape[1], cfg.resolved_head_dim
    s = tp.split(rules, H, cfg.n_heads)
    if wkv_state is None:
        wkv_state = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
    last = x[:, -1].clone()  # a copy: at batch 1 a view would keep all of ``x`` alive
    ch = slice(tp.offset(s, H * N), tp.offset(s, H * N) + H * N)  # this rank's channels
    if s is not None:
        x = tp.vary(s, x)
        p = {k: t if k in ("wr", "wk", "wv", "wg", "u") else tp.vary(s, t) for k, t in p.items()}
    xprev = _shifted(x, shift)

    def proj(w, xm):
        return (xm @ w.to(x.dtype).reshape(d, H * N)).view(B, S, H, N)

    xr, xk = _lerp(x, xprev, p["mu_r"]), _lerp(x, xprev, p["mu_k"])
    xv, xg = _lerp(x, xprev, p["mu_v"]), _lerp(x, xprev, p["mu_g"])
    xw = _lerp(x, xprev, p["mu_w"])
    r, k, v = proj(p["wr"], xr), proj(p["wk"], xk), proj(p["wv"], xv)
    g = F.silu(proj(p["wg"], xg))
    lora = torch.tanh(xw @ p["wA"].to(x.dtype)) @ p["wB"][:, ch].to(x.dtype)
    wlog = -torch.exp(p["w0"][ch] + lora.to(torch.float32)).view(B, S, H, N)

    if decode:
        y, wkv_state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], wlog[:, 0], p["u"], wkv_state)
        y = y[:, None]
    else:
        y, wkv_state = ops.wkv6(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                wlog.transpose(1, 2), p["u"], wkv_state)
        y = y.transpose(1, 2)  # (B, S, H, N)

    # per-head group norm in float32
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, H * N)
    yn = yn * p["ln_scale"][ch] + p["ln_bias"][ch]
    out = (yn.to(x.dtype) * g.reshape(B, S, H * N)) @ p["wo"][ch].to(x.dtype)
    return tp.psum(s, out), last, wkv_state


def channelmix_apply(p: Params, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                     cfg=None, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, x[:, -1] as the next shift). Under rules ``wk`` holds
    this rank's columns of the "mlp" dim (``cfg.d_ff``) and ``wv`` its rows."""
    s = None if cfg is None else tp.split(rules, p["wk"].shape[1], cfg.d_ff)
    xprev = _shifted(x, shift)
    xk, xr = _lerp(x, xprev, p["mu_k"]), _lerp(x, xprev, p["mu_r"])
    dt = x.dtype
    k = torch.square(torch.relu(tp.vary(s, xk) @ p["wk"].to(dt)))
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return r * tp.psum(s, k @ p["wv"].to(dt)), x[:, -1].clone()
