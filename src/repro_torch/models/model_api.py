"""The dense decoder-only model (counterpart of ``repro/models/model_api.py``
for the ``("attn",)`` stack): embedding, the blocks, ``final_ln``, the tied
or untied head, ``prefill``, ``decode`` and ``init_cache``.

Parameters are a dict ``{"embed", ["lm_head"], "final_ln", "layers": [per
layer {"ln1", "attn", "ln2", "ffn"}]}``; the reference stacks the layers
along a leading axis for ``lax.scan``, the port keeps one dict per layer
(:mod:`repro_torch.convert` unstacks). The cache is a list with one
``{"k", "v", "kpos"}`` dict per layer, updated in place by ``decode``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

_LATER = "is not ported yet (ROADMAP.md Queue 1: the remaining model families are later slices)"


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    if cfg.attn_free:
        return "the rwkv block"
    if cfg.block_pattern:
        return f"the {'/'.join(cfg.block_pattern)} block pattern (attn_local, rec)"
    if cfg.encoder_layers:
        return "the encoder-decoder blocks (enc, xattn)"
    if cfg.moe:
        return "the mixture-of-experts FFN"
    if cfg.num_img_tokens:
        return "image-token inputs"
    if cfg.qkv_bias:
        return "attention with qkv bias"
    if cfg.kv_cache_dtype:
        return f"the {cfg.kv_cache_dtype} KV cache"
    if cfg.window:
        return "sliding-window attention"
    if cfg.norm != "rms":
        return f"the {cfg.norm} norm"
    return None


def activation_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclass
class ModelDef:
    cfg: ArchConfig

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator, device) -> Dict[str, Any]:
        """Random parameters (normal, std 0.02; norm scales 1) from ``gen``."""
        cfg = self.cfg
        dt = activation_dtype(cfg)
        params: Dict[str, Any] = {
            "embed": L._normal(gen, (cfg.vocab, cfg.d_model), L.INIT_STD, device, dt)
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab), L.INIT_STD, device, dt)
        params["final_ln"] = L.norm_init(cfg.d_model, device)
        params["layers"] = [
            {
                "ln1": L.norm_init(cfg.d_model, device),
                "attn": L.attention_init(gen, cfg, device, dt),
                "ln2": L.norm_init(cfg.d_model, device),
                "ffn": L.mlp_init(gen, cfg, device, dt),
            }
            for _ in range(cfg.n_layers)
        ]
        return params

    # -- forward ------------------------------------------------------------
    def _head(self, params) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _ffn_half(self, lp, x):
        h = L.norm_apply(lp["ln2"], x)
        return x + L.mlp_apply(lp["ffn"], h, self.cfg)

    def prefill(self, params, tokens: torch.Tensor,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, S) int. Returns the last position's logits (B, vocab)
        and a cache of ``max(cache_len, S)`` slots holding positions 0..S-1
        (the rest empty, kpos = -1), so decode appends without wrapping."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        caches = self.init_cache(B, max(cache_len or S, S), tokens.device)
        x = params["embed"][tokens]
        for lp, cache in zip(params["layers"], caches):
            h = L.norm_apply(lp["ln1"], x)
            a, k, v = L.attention_prefill(lp["attn"], h, cfg, positions)
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            cache["kpos"][:, :S] = positions
            x = self._ffn_half(lp, x + a)
        # the final norm is per row, so normalising only the last position
        # gives the reference's x[:, -1] after its full-sequence norm
        x = L.norm_apply(params["final_ln"], x[:, -1:])
        return x[:, 0] @ self._head(params), caches

    def decode(self, params, tokens: torch.Tensor, pos: int,
               caches: List[Dict]) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, 1) int; pos: the position of every row (Python int).
        Writes the new token into each layer's cache in place and returns
        (logits (B, vocab), caches)."""
        cfg = self.cfg
        x = params["embed"][tokens]
        for lp, cache in zip(params["layers"], caches):
            h = L.norm_apply(lp["ln1"], x)
            x = self._ffn_half(lp, x + L.attention_decode(lp["attn"], h, cfg, cache, pos))
        x = L.norm_apply(params["final_ln"], x)
        return x[:, 0] @ self._head(params), caches

    # -- caches ---------------------------------------------------------------
    def init_cache(self, B: int, seq_len: int, device) -> List[Dict]:
        dt = activation_dtype(self.cfg)
        return [L.attention_cache_init(self.cfg, B, seq_len, dt, device)
                for _ in range(self.cfg.n_layers)]


def build_model(cfg: ArchConfig) -> ModelDef:
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} {_LATER}")
    return ModelDef(cfg=cfg)
