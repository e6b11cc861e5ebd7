"""Three-term roofline of one step on one device.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_wire_bytes_per_device / link_bw

The counterpart of ``repro/roofline/analysis.py``'s analytic half
(``param_count``, ``model_flops``, ``roofline_terms``); the reference's
reading of XLA's compiled cost analysis (``roofline/hlo.py``) has no
counterpart here. MODEL_FLOPS = 6*N*D (dense) is computed from the config.

The device is a parameter: :class:`HW` has no default peaks, and every
``roofline_terms`` call names its record. The port carries one,
:data:`H100_SXM`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeCfg


@dataclass(frozen=True)
class HW:
    """One device's peaks: dense FLOP/s, HBM bytes/s, one direction of its
    link to the others in bytes/s, and its memory in bytes."""

    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


# NVIDIA H100 SXM 80 GB at its 700 W power limit, from NVIDIA's data sheet:
# 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 900 GB/s (450 GB/s a
# direction), 80 GB.
H100_SXM = HW(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)


def param_count(cfg: ArchConfig) -> Dict[str, float]:
    """Analytic parameter counts: total and active-per-token."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (H + 2 * K) + H * hd * d

    if cfg.attn_free:  # rwkv6
        tm = 4 * d * H * hd + d * d + 2 * d * 64  # r/k/v/g + out + decay lora
        cm = d * f + f * d + d * d
        block_total = tm + cm
        per_layer = [block_total] * L
        active_per_layer = per_layer
    elif cfg.block_pattern:
        w = cfg.lru_width or d
        rec = 2 * d * w + 2 * w * w + w * d + cfg.conv_width * w
        mlp = 3 * d * f
        per_layer, active_per_layer = [], []
        pat = cfg.block_pattern
        for i in range(L):
            kind = pat[i % len(pat)]
            p = (rec if kind == "rec" else attn) + mlp
            per_layer.append(p)
            active_per_layer.append(p)
    elif cfg.moe:
        shared = 3 * d * f * cfg.n_shared_experts
        router = d * cfg.n_experts
        experts_total = cfg.n_experts * 3 * d * f
        experts_active = cfg.top_k * 3 * d * f
        per_layer = [attn + router + shared + experts_total] * L
        active_per_layer = [attn + router + shared + experts_active] * L
    else:
        mlp = 3 * d * f if cfg.mlp in ("swiglu", "geglu") else 2 * d * f
        per_layer = [attn + mlp] * L
        active_per_layer = per_layer

    emb = V * d * (1 if cfg.tie_embeddings else 2)
    enc = 0
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (attn + 2 * d * f)
    total = sum(per_layer) + emb + enc
    active = sum(active_per_layer) + emb + enc
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ArchConfig, shape: ShapeCfg) -> float:
    """6*N*D with N = active params (MoE) and D = processed tokens."""
    n = param_count(cfg)["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token per row
    return 2.0 * n * shape.global_batch


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_wire_bytes_per_dev: float,
    hw: HW,
) -> Dict[str, float]:
    ct = flops_per_dev / hw.peak_flops
    mt = bytes_per_dev / hw.hbm_bw
    xt = coll_wire_bytes_per_dev / hw.link_bw
    dom = max(("compute", ct), ("memory", mt), ("collective", xt), key=lambda p: p[1])
    step = max(ct, mt, xt)
    return {
        "compute_s": ct,
        "memory_s": mt,
        "collective_s": xt,
        "bottleneck": dom[0],
        "step_lower_bound_s": step,
        # fraction of the bound step that is pure compute = roofline fraction
        "roofline_fraction": (ct / step) if step > 0 else 0.0,
    }
