"""RG-LRU recurrent block (counterpart of ``repro/models/rglru.py``,
RecurrentGemma / Griffin).

Block: norm -> [linear -> causal temporal conv1d (width cw) -> RG-LRU]
             * [linear -> GeLU] -> linear out.

RG-LRU: h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) with
a_t = exp(-c softplus(Lambda) sigmoid(W_a x_t)), c = 8. The prefill's scan
goes through :func:`repro_torch.kernels.ops.rglru` (the CUDA kernel on the
card); decode is the one-step recurrence in plain torch, as in the
reference.

Parameter dtypes follow the reference's use: the gate weights and biases
``wa``, ``ba``, ``wi``, ``bi`` and ``lam`` enter float32 products uncast,
so they stay float32; every other weight is stored in the activation dtype
for serving and cast to it at use, as the reference casts it, so that
training's float32 masters run the same arithmetic. Under autograd the
scan's backward is the CUDA rglru backward kernel on the card.

Under ``rules`` (:mod:`repro_torch.sharding.tp`) the block runs this
rank's "lru" channels: ``wx`` / ``wy`` are column-split, the conv and the
scan run on the local channels, ``wo`` is row-split and its output a part
summed over "model". ``wa`` and ``wi`` are split by rows only (the rules
give their second "lru" dim no axis), so the gate products are parts of
the whole width: one reduce-scatter over "model" sums them onto this
rank's columns.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding import tp

RGLRU_C = 8.0
LAMBDA_INIT = -4.83  # softplus(-4.83) ~ 0.008 -> a ~ exp(-0.032) ~ 0.97

#: the RG-LRU leaves kept in float32, by ``rglru_block_init`` and by ``convert``
F32_KEYS = ("wa", "ba", "wi", "bi", "lam")

Params = Dict[str, torch.Tensor]


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


#: the logical axes of ``rglru_block_init``'s leaves (the reference's) and
#: of a rec layer's decode cache
RGLRU_AXES = {"wx": ("embed", "lru"), "wy": ("embed", "lru"), "conv_w": ("conv", "lru"),
              "conv_b": ("lru",), "wa": ("lru", "lru"), "ba": ("lru",), "wi": ("lru", "lru"),
              "bi": ("lru",), "lam": ("lru",), "wo": ("lru", "embed")}
CACHE_AXES = {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}


def rglru_block_init(gen, cfg, device, dtype) -> Params:
    d, w, cw = cfg.d_model, lru_width(cfg), cfg.conv_width

    def dt(name):
        return torch.float32 if name in F32_KEYS else dtype

    return {
        "wx": L._normal(gen, (d, w), L.INIT_STD, device, dt("wx")),
        "wy": L._normal(gen, (d, w), L.INIT_STD, device, dt("wy")),
        "conv_w": torch.full((cw, w), 1.0 / cw, dtype=dt("conv_w"), device=device),
        "conv_b": torch.zeros((w,), dtype=dt("conv_b"), device=device),
        "wa": L._normal(gen, (w, w), L.INIT_STD, device, dt("wa")),
        "ba": torch.zeros((w,), dtype=dt("ba"), device=device),
        "wi": L._normal(gen, (w, w), L.INIT_STD, device, dt("wi")),
        "bi": torch.zeros((w,), dtype=dt("bi"), device=device),
        "lam": torch.full((w,), LAMBDA_INIT, dtype=dt("lam"), device=device),
        "wo": L._normal(gen, (w, d), L.INIT_STD, device, dt("wo")),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, S, lru); temporal conv over S with the taps w (cw, lru).
    conv_state: (B, cw-1, lru), the last cw-1 inputs of the previous call
    (zeros for a fresh sequence). Returns (out, the new conv_state)."""
    cw = w.shape[0]
    w, b = w.to(u.dtype), b.to(u.dtype)
    if conv_state is None:
        conv_state = torch.zeros_like(u[:, :1]).expand(-1, cw - 1, -1)
    up = torch.cat([conv_state, u], dim=1)  # (B, S+cw-1, lru)
    S = u.shape[1]
    out = up[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + up[:, i:i + S] * w[i]
    return out + b, up[:, S:].clone()  # a copy: at batch 1 a view would keep ``up`` alive


def rglru_block_apply(p: Params, x: torch.Tensor, cfg, h_state: Optional[torch.Tensor] = None,
                      conv_state: Optional[torch.Tensor] = None, decode: bool = False,
                      rules=None):
    """x: (B, S, d). Returns (out (B, S, d), h (B, lru) float32, conv_state;
    this rank's channels under rules)."""
    B = x.shape[0]
    s = tp.split(rules, p["wx"].shape[1], lru_width(cfg))
    if h_state is None:
        h_state = torch.zeros((B, p["wx"].shape[1]), dtype=torch.float32, device=x.device)
    x = tp.vary(s, x)
    dt = x.dtype
    u, conv_state = causal_conv(x @ p["wx"].to(dt), p["conv_w"], p["conv_b"], conv_state)

    uf = u.to(torch.float32)
    ga, gi = uf @ p["wa"], uf @ p["wi"]
    if s is not None:  # parts of the whole width: summed onto this rank's columns
        ga, gi = C.psum_scatter(torch.stack([ga, gi]), s.mesh, "model", dim=-1).unbind(0)
    r = torch.sigmoid(ga + p["ba"])
    i = torch.sigmoid(gi + p["bi"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r  # (B, S, lru) <= 0
    m = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * uf)

    if decode:
        h_state = torch.exp(log_a[:, 0]) * h_state + m[:, 0]
        hs = h_state[:, None]
    else:
        hs, h_state = ops.rglru(log_a, m, h_state)

    gate = L.gelu(x @ p["wy"].to(dt))
    return tp.psum(s, (hs.to(dt) * gate) @ p["wo"].to(dt)), h_state, conv_state
