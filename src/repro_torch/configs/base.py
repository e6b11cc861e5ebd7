"""Architecture and input-shape configuration (counterpart of
``repro/configs/base.py``).

The port registers only the architectures it runs. ``get_arch`` of any
other name raises ``KeyError`` that says so, rather than handing back a
config the port's model cannot build.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    norm: str = "rms"  # rms | layer
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- recurrent / hybrid ---
    attn_free: bool = False  # rwkv6: no attention at all
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec","rec","attn") for griffin
    window: int = 0  # sliding-window size for local attention (0 = full)
    lru_width: Optional[int] = None
    conv_width: int = 4
    # --- MoE (models/moe.py) ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "auto"  # auto | manual (expert parallelism over the mesh's "model" axis)
    # --- enc-dec (whisper), multimodal stubs, the KV cache's storage ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # whisper: 1500 precomputed frame embeddings
    num_img_tokens: int = 0  # phi-3-vision; the port's build_model refuses it
    kv_cache_dtype: str = ""  # "" (= activation dtype) | "int8" (serving)
    # --- numerics and training ---
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"  # the training masters' dtype (serving keeps ``dtype``)
    optimizer: str = "adamw"  # adamw | adafactor | sgdm
    fsdp: bool = False  # ZeRO-style sharding over the data axes (models/moe.py's manual path)
    remat: bool = True  # recompute each block in the backward (torch.utils.checkpoint)
    source: str = ""  # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if serving memory/compute does not grow quadratically in seq."""
        if self.attn_free:
            return True
        # a hybrid whose only attention is windowed (griffin)
        return bool(self.block_pattern and self.window > 0 and "full" not in self.block_pattern)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family variant for CPU tests; the same changes as
        ``repro.configs.base.ArchConfig.reduced`` for the families the port
        runs (dense, moe, rwkv, block pattern, encoder-decoder)."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else self.n_kv_heads,
            d_ff=128,
            vocab=512,
            head_dim=16,
            dtype="float32",
            fsdp=False,
        )
        if self.moe:
            # capacity_factor = n_experts -> drop-free dispatch, so the
            # smoke/exactness tests are deterministic across prefill/decode
            changes.update(n_experts=4, top_k=2, capacity_factor=4.0)
        if self.block_pattern:
            changes["block_pattern"] = self.block_pattern  # keep the pattern unit
            changes["n_layers"] = len(self.block_pattern)  # one pattern group
            changes["window"] = min(self.window, 16) if self.window else 0
        if self.window and not self.block_pattern:
            changes["window"] = 16
        if self.lru_width:
            changes["lru_width"] = 64
        if self.encoder_layers:
            changes["encoder_layers"] = 1
            changes["encoder_seq"] = 16
        if self.attn_free:
            changes["n_heads"] = 4
            changes["head_dim"] = 16
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def applicable(arch: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell of the dry run; if not, why."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k skipped: full (quadratic) attention arch"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet; the port runs "
            f"{sorted(_REGISTRY)} (the other families are later slices in ROADMAP.md)"
        )
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401  (each registers on import)
        deepseek_7b,
        gemma_2b,
        granite_3_2b,
        olmoe_1b_7b,
        qwen25_3b,
        recurrentgemma_9b,
        rwkv6_1b6,
        whisper_tiny,
    )
