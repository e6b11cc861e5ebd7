"""The decoder-only model (counterpart of ``repro/models/model_api.py``):
embedding, the blocks, ``final_ln``, the tied or untied head, ``loss``,
``prefill``, ``decode`` and ``init_cache``.

A model is a list of *stacks*, each a (pattern unit, repeats) pair, as in
the reference: (("attn",), 18) for gemma, (("rwkv",), 24) for rwkv6,
(("rec", "rec", "attn_local"), 12) + (("rec", "rec"), 1) for
recurrentgemma. The reference stacks each block's weights along a leading
axis for ``lax.scan``; the port keeps one dict per layer in model order
(:mod:`repro_torch.convert` unstacks), with ``ModelDef.kinds`` naming each
layer's block kind. Parameters are ``{"embed", ["lm_head"], "final_ln",
"layers": [...]}``; the cache is a list with one dict per layer, updated
in place by ``decode``.

Block kinds and their caches:
  attn        full causal attention + FFN          {"k", "v", "kpos"}
  attn_local  sliding-window attention + FFN       {"k", "v", "kpos"}, min(S, window) slots
  rec         RG-LRU temporal block + FFN          {"h" float32, "conv"}
  rwkv        RWKV6 time-mix + channel-mix         {"wkv" float32, "shift_t", "shift_c"}

``loss`` trains the attention kinds; ``rec`` and ``rwkv`` blocks raise (their
kernels have no backward yet).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R

_LATER = "is not ported yet (ROADMAP.md Queue 1: the remaining model families are later slices)"
_PATTERN_KINDS = ("rec", "attn")
_TRAINABLE = ("attn", "attn_local")
_NOT_TRAINABLE = ("cannot train yet: the wkv6 and rglru_scan kernels have no backward "
                  "(ROADMAP.md Queue 1, item 9: rwkv6 and recurrentgemma training)")
#: the cross-entropy's chunk of positions (the reference's ``_chunked_ce``)
CE_CHUNK = 512


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    if set(cfg.block_pattern) - set(_PATTERN_KINDS):
        return f"the {'/'.join(cfg.block_pattern)} block pattern (only {_PATTERN_KINDS})"
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
    if cfg.norm != "rms":
        return f"the {cfg.norm} norm"
    return None


def _stacks_for(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.attn_free:
        return [(("rwkv",), cfg.n_layers)]
    if cfg.block_pattern:
        unit = tuple("attn_local" if b == "attn" else b for b in cfg.block_pattern)
        reps = cfg.n_layers // len(unit)
        rem = cfg.n_layers - reps * len(unit)
        stacks = [(unit, reps)]
        if rem:
            stacks.append((unit[:rem], 1))
        return stacks
    return [(("attn",), cfg.n_layers)]


def activation_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "attn_local" else 0


@dataclass
class ModelDef:
    cfg: ArchConfig
    kinds: List[str] = field(init=False)

    def __post_init__(self):
        # each layer's block kind in model order: the stacks' units, repeated
        self.kinds = [kind for unit, reps in _stacks_for(self.cfg) for _ in range(reps)
                      for kind in unit]

    # -- init ---------------------------------------------------------------
    def _block_init(self, kind: str, gen, device, dt) -> Dict[str, Any]:
        cfg, d = self.cfg, self.cfg.d_model
        if kind == "rwkv":
            return {"ln1": L.norm_init(d, device), "tm": R.timemix_init(gen, cfg, device, dt),
                    "ln2": L.norm_init(d, device), "cm": R.channelmix_init(gen, cfg, device, dt)}
        mixer = ({"rec": G.rglru_block_init(gen, cfg, device, dt)} if kind == "rec"
                 else {"attn": L.attention_init(gen, cfg, device, dt)})
        return {"ln1": L.norm_init(d, device), **mixer, "ln2": L.norm_init(d, device),
                "ffn": L.mlp_init(gen, cfg, device, dt)}

    def init(self, gen: torch.Generator, device, param_dtype: Optional[torch.dtype] = None
             ) -> Dict[str, Any]:
        """Random parameters from ``gen``: matrices normal (std 0.02, the
        decay LoRA 0.01), norm scales 1, and the reference's constant
        initialisers for the rwkv and RG-LRU parameters. The matrices are
        stored in ``param_dtype`` (default: the activation dtype, for
        serving; training passes float32 masters, cast at use)."""
        cfg = self.cfg
        dt = param_dtype or activation_dtype(cfg)
        params: Dict[str, Any] = {
            "embed": L._normal(gen, (cfg.vocab, cfg.d_model), L.INIT_STD, device, dt)
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab), L.INIT_STD, device, dt)
        params["final_ln"] = L.norm_init(cfg.d_model, device)
        params["layers"] = [self._block_init(kind, gen, device, dt) for kind in self.kinds]
        return params

    # -- forward ------------------------------------------------------------
    def _head(self, params, dtype) -> torch.Tensor:
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return head.to(dtype)

    def _embed(self, params, tokens) -> torch.Tensor:
        return F.embedding(tokens, params["embed"]).to(activation_dtype(self.cfg))

    def _ffn_half(self, lp, x):
        h = L.norm_apply(lp["ln2"], x)
        return x + L.mlp_apply(lp["ffn"], h, self.cfg)

    def _kv_cache(self, k, v, positions, window: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """The decode cache of an attention layer after the prefill. As the
        reference's ``_kv_from_prefill``: a windowed layer keeps exactly the
        last min(S, window) positions, in order; a full layer gets
        ``max(cache_len, S)`` slots, positions 0..S-1 then empty ones
        (kpos = -1), so decode appends without wrapping."""
        B, S = positions.shape
        kpos = positions.to(torch.int32)
        if window:
            W = min(S, window)
            return {"k": k[:, -W:].contiguous(), "v": v[:, -W:].contiguous(),
                    "kpos": kpos[:, -W:].contiguous()}
        cache = self._block_cache("attn", B, max(cache_len, S), k.dtype, k.device)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["kpos"][:, :S] = kpos
        return cache

    def _block_prefill(self, kind: str, lp, x, positions, cache_len: int):
        cfg = self.cfg
        h = L.norm_apply(lp["ln1"], x)
        if kind == "rwkv":
            t, shift_t, wkv = R.timemix_apply(lp["tm"], h, cfg)
            x = x + t
            c, shift_c = R.channelmix_apply(lp["cm"], L.norm_apply(lp["ln2"], x))
            return x + c, {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}
        if kind == "rec":
            r, h_state, conv = G.rglru_block_apply(lp["rec"], h, cfg)
            return self._ffn_half(lp, x + r), {"h": h_state, "conv": conv}
        window = _window(cfg, kind)
        a, k, v = L.attention_prefill(lp["attn"], h, cfg, positions, window)
        return self._ffn_half(lp, x + a), self._kv_cache(k, v, positions, window, cache_len)

    def _block_decode(self, kind: str, lp, x, cache, pos: int):
        cfg = self.cfg
        h = L.norm_apply(lp["ln1"], x)
        if kind == "rwkv":
            t, cache["shift_t"], cache["wkv"] = R.timemix_apply(
                lp["tm"], h, cfg, cache["shift_t"], cache["wkv"], decode=True)
            x = x + t
            c, cache["shift_c"] = R.channelmix_apply(
                lp["cm"], L.norm_apply(lp["ln2"], x), cache["shift_c"])
            return x + c
        if kind == "rec":
            r, cache["h"], cache["conv"] = G.rglru_block_apply(
                lp["rec"], h, cfg, cache["h"], cache["conv"], decode=True)
            return self._ffn_half(lp, x + r)
        a = L.attention_decode(lp["attn"], h, cfg, cache, pos, _window(cfg, kind))
        return self._ffn_half(lp, x + a)

    def prefill(self, params, tokens: torch.Tensor,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, S) int. Returns the last position's logits (B, vocab)
        and the per-layer caches (see ``_kv_cache`` for the attention
        layers; the recurrent layers keep their final states)."""
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = self._embed(params, tokens)
        caches = []
        for kind, lp in zip(self.kinds, params["layers"]):
            x, cache = self._block_prefill(kind, lp, x, positions, cache_len or S)
            caches.append(cache)
        # the final norm is per row, so normalising only the last position
        # gives the reference's x[:, -1] after its full-sequence norm
        x = L.norm_apply(params["final_ln"], x[:, -1:])
        return x[:, 0] @ self._head(params, x.dtype), caches

    def decode(self, params, tokens: torch.Tensor, pos: int,
               caches: List[Dict]) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, 1) int; pos: the position of every row (Python int).
        Updates each layer's cache in place and returns (logits (B, vocab),
        caches)."""
        x = self._embed(params, tokens)
        for kind, lp, cache in zip(self.kinds, params["layers"], caches):
            x = self._block_decode(kind, lp, x, cache, pos)
        x = L.norm_apply(params["final_ln"], x)
        return x[:, 0] @ self._head(params, x.dtype), caches

    # -- training -------------------------------------------------------------
    def _block_train(self, kind: str, lp, x, positions):
        h = L.norm_apply(lp["ln1"], x)
        a = L.attention_train(lp["attn"], h, self.cfg, positions, _window(self.cfg, kind))
        return self._ffn_half(lp, x + a)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S) (an
        int array or tensor), as the reference's ``loss``: position t
        predicts token t + 1, the last slot is masked, the cross-entropy is
        taken over the vocabulary in chunks of CE_CHUNK positions, each
        recomputed in the backward (the reference's ``jax.checkpoint(piece)``),
        and with ``cfg.remat`` every block is recomputed in the backward too.
        The reference adds 0.01 x the MoE aux term, 0 for these dense models.
        Attention and the norms run the CUDA kernels, forward and backward,
        on the card."""
        bad = sorted(set(self.kinds) - set(_TRAINABLE))
        if bad:
            raise NotImplementedError(f"{self.cfg.name}: {'/'.join(bad)} blocks {_NOT_TRAINABLE}")
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"]).to(device=embed.device, dtype=torch.int64)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=embed.device).expand(B, S)
        x = self._embed(params, tokens)
        for kind, lp in zip(self.kinds, params["layers"]):
            if self.cfg.remat:
                x = checkpoint(self._block_train, kind, lp, x, positions, use_reentrant=False)
            else:
                x = self._block_train(kind, lp, x, positions)
        x = L.norm_apply(params["final_ln"], x)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones((B, S), dtype=torch.float32, device=embed.device)
        mask[:, -1] = 0.0
        return _chunked_ce(x, self._head(params, x.dtype), labels, mask)

    # -- caches ---------------------------------------------------------------
    def _block_cache(self, kind: str, B: int, seq_len: int, dt, device) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if kind == "rwkv":
            H, N = cfg.n_heads, cfg.resolved_head_dim
            return {"wkv": torch.zeros((B, H, N, N), dtype=torch.float32, device=device),
                    "shift_t": torch.zeros((B, cfg.d_model), dtype=dt, device=device),
                    "shift_c": torch.zeros((B, cfg.d_model), dtype=dt, device=device)}
        if kind == "rec":
            w = G.lru_width(cfg)
            return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
                    "conv": torch.zeros((B, cfg.conv_width - 1, w), dtype=dt, device=device)}
        length = min(cfg.window or seq_len, seq_len) if kind == "attn_local" else seq_len
        return L.attention_cache_init(cfg, B, length, dt, device)

    def init_cache(self, B: int, seq_len: int, device) -> List[Dict]:
        """Empty caches for a fresh sequence of up to ``seq_len`` positions."""
        dt = activation_dtype(self.cfg)
        return [self._block_cache(kind, B, seq_len, dt, device) for kind in self.kinds]


def _ce_piece(hc, head, lc, mc):
    logits = (hc @ head).to(torch.float32)  # (B, c, V)
    lz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((lz - ll) * mc)


def _chunked_ce(h, head, labels, mask) -> torch.Tensor:
    """sum over chunks of CE_CHUNK positions of the masked cross-entropy,
    each chunk under ``torch.utils.checkpoint``, divided by the mask's sum
    (at least 1): the (B, S, vocab) logits are never all held at once."""
    T = h.shape[1]
    c = min(CE_CHUNK, T)
    while T % c:
        c //= 2
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, c):
        total = total + checkpoint(_ce_piece, h[:, i:i + c], head, labels[:, i:i + c],
                                   mask[:, i:i + c], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def build_model(cfg: ArchConfig) -> ModelDef:
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} {_LATER}")
    return ModelDef(cfg=cfg)
