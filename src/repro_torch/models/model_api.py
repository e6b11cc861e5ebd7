"""The model (counterpart of ``repro/models/model_api.py``): embedding, the
blocks, ``final_ln``, the tied or untied head, ``loss``, ``prefill``,
``decode`` and ``init_cache``; for an encoder-decoder config (whisper) the
encoder, learned positions and the cross-attention too.

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
  enc         not-causal encoder attention + FFN   (none: the encoder runs in the prefill)
  xattn       causal self-attention + cross-attention to the encoder's memory + FFN
                                                   {"k", "v", "kpos"}

With ``cfg.kv_cache_dtype == "int8"`` every attention cache holds int8 k /
v and float16 "k_scale" / "v_scale" (B, W, n), the reference's layout.

With ``cfg.moe`` an attention block's FFN is the mixture of experts of
:mod:`repro_torch.models.moe`, whose load-balance term ``loss`` adds.

An encoder-decoder config (``cfg.encoder_layers``; whisper) adds
``"pos_embed"`` (32768 learned positions, added to the tokens; no RoPE
anywhere), ``"enc_pos"`` (added to the frames), ``"encoder"`` (one dict a
layer, kind ``enc``) and ``"enc_ln"``; its layers are ``xattn``. The
prefill takes ``frames`` (B, encoder_seq, d), the stub of precomputed
frame embeddings, encodes them and keeps the memory as the cache's last
entry, ``{"memory": (B, encoder_seq, d)}``: the reference's
``caches["memory"]``. Each decode step projects the memory's k / v again,
as the reference does. ``loss`` takes the frames in its batch and encodes
them the same way (the encoder blocks are not recomputed in the backward,
as the reference's ``_encode`` is not); its cross-attention's backward
gives the memory's gradient, through which the encoder trains.

A vision config (``cfg.num_img_tokens``; phi-3-vision) takes
``image_embeds`` (B, num_img_tokens, d), the stub of precomputed patch
embeddings, in ``prefill`` and in ``loss``'s batch: they are prepended to
the token embeddings, the positions (and RoPE) run over S_tot = S +
num_img_tokens, the prefill's cache holds S_tot positions, and the loss's
cross-entropy is taken over the text positions only. Decode needs no
change: the caller passes positions that continue after S_tot - 1.
Without ``image_embeds`` such a config runs as a text-only one, as the
reference does.

Over a mesh (``rules``, :mod:`repro_torch.sharding.rules`) each rank runs
``prefill``, ``decode`` and ``loss`` on its data shard of the batch and
holds every leaf as ``run_specs`` says: the rules' spec, the reference's
layout. The reference gets its "model"-axis split of attention, MLP,
RG-LRU, RWKV heads, experts and vocabulary from XLA's partitioner; the
port's blocks split their own work (:mod:`repro_torch.sharding.tp`). The
vocabulary: the embedding looks up the rows of this rank's block, masked,
and sums over "model"; the head gives this rank's columns of the logits,
which ``prefill`` and ``decode`` gather, and the cross-entropy reduces its
max, its sum of exponentials and the label's logit over "model". Every FFN
gets the rules, as the reference's ``_ffn_apply`` does: an MoE with
``moe_impl="manual"`` takes the expert-parallel path over "model".
``loss`` returns the global batch's loss on every rank. ``param_axes``,
``abstract_init``, ``input_specs`` and ``abstract_cache`` give the logical
axes and shapes the rules read.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.sharding import collectives as C
from repro_torch.sharding import tp
from repro_torch.sharding.rules import MeshRules, constrain, entry_axes, map_specs

_LATER = "is not ported yet (ROADMAP.md Queue 1: the remaining model families are later slices)"
_PATTERN_KINDS = ("rec", "attn")
#: the cross-entropy's chunk of positions (the reference's ``_chunked_ce``)
CE_CHUNK = 512
#: learned positions of an encoder-decoder (the reference's ``pos_embed`` rows)
POS_ROWS = 32768
#: the logical axes of the frames and of the encoder's memory
MEMORY_AXES = ("batch", "frames", None)
#: the logical axes of a vision config's precomputed patch embeddings
IMAGE_AXES = ("batch", "img", None)


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    if set(cfg.block_pattern) - set(_PATTERN_KINDS):
        return f"the {'/'.join(cfg.block_pattern)} block pattern (only {_PATTERN_KINDS})"
    if cfg.moe and (cfg.block_pattern or cfg.attn_free or cfg.encoder_layers):
        return "the mixture-of-experts FFN in a recurrent or encoder-decoder block"
    if cfg.kv_cache_dtype not in ("", "int8"):
        return f"the {cfg.kv_cache_dtype} KV cache"
    if cfg.norm not in ("rms", "layer"):
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
    if cfg.encoder_layers:  # whisper's decoder
        return [(("xattn",), cfg.n_layers)]
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
        # learned positions and no RoPE (whisper), as the reference's _learned_pos
        self.learned_pos = self.cfg.encoder_layers > 0

    def _ln(self, p, x):
        return L.norm_apply(p, x, self.cfg.norm)

    # -- init ---------------------------------------------------------------
    def _block_init(self, kind: str, gen, device, dt) -> Dict[str, Any]:
        cfg, d = self.cfg, self.cfg.d_model
        norm = functools.partial(L.norm_init, d, device, cfg.norm)
        if kind == "rwkv":
            return {"ln1": norm(), "tm": R.timemix_init(gen, cfg, device, dt),
                    "ln2": norm(), "cm": R.channelmix_init(gen, cfg, device, dt)}
        mixer = ({"rec": G.rglru_block_init(gen, cfg, device, dt)} if kind == "rec"
                 else {"attn": L.attention_init(gen, cfg, device, dt)})
        if kind == "xattn":
            mixer.update(lnx=norm(), xattn=L.attention_init(gen, cfg, device, dt))
        ffn = M.moe_init(gen, cfg, device, dt) if cfg.moe else L.mlp_init(gen, cfg, device, dt)
        return {"ln1": norm(), **mixer, "ln2": norm(), "ffn": ffn}

    def init(self, gen: torch.Generator, device, param_dtype: Optional[torch.dtype] = None
             ) -> Dict[str, Any]:
        """Random parameters from ``gen``: matrices normal (std 0.02, the
        decay LoRA 0.01), norm scales 1, and the reference's constant
        initialisers for the rwkv and RG-LRU parameters. The matrices are
        stored in ``param_dtype`` (default: the activation dtype, for
        serving; training passes float32 masters, cast at use). An
        encoder-decoder's learned positions are normal with std 0.01."""
        cfg = self.cfg
        dt = param_dtype or activation_dtype(cfg)
        params: Dict[str, Any] = {
            "embed": L._normal(gen, (cfg.vocab, cfg.d_model), L.INIT_STD, device, dt)
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab), L.INIT_STD, device, dt)
        params["final_ln"] = L.norm_init(cfg.d_model, device, cfg.norm)
        if self.learned_pos:
            params["pos_embed"] = L._normal(gen, (POS_ROWS, cfg.d_model), 0.01, device, dt)
        params["layers"] = [self._block_init(kind, gen, device, dt) for kind in self.kinds]
        if cfg.encoder_layers:
            params["enc_pos"] = L._normal(gen, (cfg.encoder_seq, cfg.d_model), 0.01, device, dt)
            params["encoder"] = [self._block_init("enc", gen, device, dt)
                                 for _ in range(cfg.encoder_layers)]
            params["enc_ln"] = L.norm_init(cfg.d_model, device, cfg.norm)
        return params

    # -- logical axes and abstract trees ---------------------------------------
    def _block_axes(self, kind: str) -> Dict[str, Any]:
        cfg = self.cfg
        norm = functools.partial(L.norm_axes, cfg.norm)
        if kind == "rwkv":
            return {"ln1": norm(), "tm": dict(R.TIMEMIX_AXES), "ln2": norm(),
                    "cm": dict(R.CHANNELMIX_AXES)}
        mixer = ({"rec": dict(G.RGLRU_AXES)} if kind == "rec"
                 else {"attn": L.attention_axes(cfg)})
        if kind == "xattn":
            mixer.update(lnx=norm(), xattn=L.attention_axes(cfg))
        ffn = M.moe_axes(cfg) if cfg.moe else L.mlp_axes(cfg)
        return {"ln1": norm(), **mixer, "ln2": norm(), "ffn": ffn}

    def param_axes(self) -> Dict[str, Any]:
        """The logical axes of every leaf of ``init``'s tree, the same
        structure: a layer's are the reference's with its leading "layers"
        entry dropped (the port keeps one dict a layer)."""
        cfg = self.cfg
        axes: Dict[str, Any] = {"embed": ("vocab", "embed")}
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        axes["final_ln"] = L.norm_axes(cfg.norm)
        if self.learned_pos:
            axes["pos_embed"] = (None, "embed")
        axes["layers"] = [self._block_axes(kind) for kind in self.kinds]
        if cfg.encoder_layers:
            axes["enc_pos"] = (None, "embed")
            axes["encoder"] = [self._block_axes("enc") for _ in range(cfg.encoder_layers)]
            axes["enc_ln"] = L.norm_axes(cfg.norm)
        return axes

    def abstract_init(self) -> Dict[str, Any]:
        """``init``'s tree on the meta device (shapes and dtypes, no
        storage), the matrices in ``cfg.param_dtype`` as training holds them;
        a ``param_dtype`` other than float32 holds every floating leaf in
        it, the norms too, as the reference's ``init`` casts them."""
        pd = getattr(torch, self.cfg.param_dtype)
        params = self.init(None, "meta", param_dtype=pd)
        if pd == torch.float32:
            return params
        return map_specs(lambda _, t: t.to(pd) if t.is_floating_point() else t,
                         self.param_axes(), params)

    def run_specs(self, rules: MeshRules) -> Dict[str, Any]:
        """How each parameter leaf lies over the mesh when the port runs
        under ``rules``: the rules' spec of every leaf (the reference's
        ``shard_tree``), the MoE leaves of the manual path as
        ``moe.manual_specs`` lays them out (the same spec, FSDP of the
        experts aside). The same structure as ``param_axes``. Rules that
        lay a dense leaf over the data axes (FSDP of the dense leaves)
        raise: the port splits dense leaves over "model" only."""
        specs = map_specs(lambda ax, t: rules.spec_for(tuple(ax), tuple(t.shape)),
                          self.param_axes(), self.abstract_init())
        manual = self.cfg.moe and M.uses_manual(self.cfg, rules)
        dense = dict(specs, layers=[{k: v for k, v in layer.items()
                                     if not (manual and k == "ffn")}
                                    for layer in specs["layers"]])
        on_data = []
        map_specs(lambda spec: on_data.append(spec) if any(
            a in rules.data_axes for e in spec for a in entry_axes(e)) else None, dense)
        if on_data:
            raise NotImplementedError(
                f"{self.cfg.name}: rules that lay dense leaves over the data axes (FSDP of the "
                f"dense leaves, e.g. {on_data[0]}) are not ported yet (ROADMAP.md Queue 1, "
                f"item 9.9)")
        if manual:
            for layer in specs["layers"]:
                if "ffn" in layer:
                    layer["ffn"] = M.manual_specs(self.cfg, rules)
        return specs

    def input_specs(self, shape: ShapeCfg) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
        """(the inputs of a step of ``shape`` as meta tensors, their logical
        axes): the reference's ``input_specs`` split into values and axes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = functools.partial(torch.empty, dtype=torch.int32, device="meta")
        if shape.kind == "decode":
            return {"tokens": meta((B, 1)), "pos": meta(())}, {"tokens": ("batch", None),
                                                             "pos": ()}
        # a vision config's image tokens count in the step's seq_len
        values = {"tokens": meta((B, S - cfg.num_img_tokens))}
        axes = {"tokens": ("batch", "seq")}
        if cfg.num_img_tokens:
            values["image_embeds"] = torch.empty((B, cfg.num_img_tokens, cfg.d_model),
                                                 dtype=activation_dtype(cfg), device="meta")
            axes["image_embeds"] = IMAGE_AXES
        if cfg.encoder_layers:
            values["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                           dtype=activation_dtype(cfg), device="meta")
            axes["frames"] = MEMORY_AXES
        return values, axes

    def cache_axes(self) -> List[Dict[str, Tuple]]:
        """The logical axes of ``init_cache``'s tree (the reference's with
        its leading "layers" entry dropped)."""
        by_kind = {"rwkv": R.CACHE_AXES, "rec": G.CACHE_AXES}
        axes = [dict(by_kind.get(kind) or L.cache_axes(self.cfg)) for kind in self.kinds]
        if self.cfg.encoder_layers:
            axes.append({"memory": MEMORY_AXES})
        return axes

    def abstract_cache(self, B: int, seq_len: int) -> Tuple[List[Dict], List[Dict]]:
        """(``init_cache(B, seq_len)`` on the meta device, its axes)."""
        return self.init_cache(B, seq_len, "meta"), self.cache_axes()

    # -- forward ------------------------------------------------------------
    def _head(self, params, dtype) -> torch.Tensor:
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return head.to(dtype)

    def _vocab_split(self, params, rules) -> Optional[tp.Split]:
        """The "model"-axis split of the head's vocabulary (None: whole)."""
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return tp.split(rules, head.shape[1], self.cfg.vocab)

    def _embed(self, params, tokens, rules=None) -> torch.Tensor:
        table = params["embed"]
        s = tp.split(rules, table.shape[0], self.cfg.vocab)
        if s is None:
            return F.embedding(tokens, table).to(activation_dtype(self.cfg))
        # this rank's block of rows: the tokens inside it, the others zeros
        local = tokens - tp.offset(s, table.shape[0])
        inside = (local >= 0) & (local < table.shape[0])
        e = F.embedding(torch.where(inside, local, torch.zeros_like(local)), table)
        e = torch.where(inside[..., None], e, torch.zeros_like(e))
        return tp.psum(s, e).to(activation_dtype(self.cfg))

    def _logits(self, params, x, rules=None) -> torch.Tensor:
        """x (B, d) -> the whole vocabulary's logits (B, vocab): this rank's
        columns, gathered over "model" where the vocabulary splits."""
        s = self._vocab_split(params, rules)
        logits = tp.vary(s, x) @ self._head(params, x.dtype)
        return logits if s is None else C.all_gather(logits, s.mesh, "model", dim=-1)

    def _ffn_half(self, lp, x, rules=None):
        """(x + the FFN of its norm, the MoE aux term or None)."""
        h = self._ln(lp["ln2"], x)
        if self.cfg.moe:
            f, aux = M.moe_apply(lp["ffn"], h, self.cfg, rules)
            return x + f, aux
        return x + L.mlp_apply(lp["ffn"], h, self.cfg, rules), None

    def _kv_cache(self, k, v, positions, window: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """The decode cache of an attention layer after the prefill. As the
        reference's ``_kv_from_prefill``: a windowed layer keeps exactly the
        last min(S, window) positions, in order; a full layer gets
        ``max(cache_len, S)`` slots, positions 0..S-1 then empty ones
        (kpos = -1, k / v and scales zero), so decode appends without
        wrapping. An int8 cache holds the kept positions quantized."""
        B, S = positions.shape
        kpos = positions.to(torch.int32)
        if window:
            W = min(S, window)
            k, v, kpos = k[:, -W:], v[:, -W:], kpos[:, -W:]
        if self.cfg.kv_cache_dtype == "int8":
            (k, k_scale), (v, v_scale) = L._quantize_kv(k), L._quantize_kv(v)
            entries = {"k": k, "v": v, "kpos": kpos, "k_scale": k_scale, "v_scale": v_scale}
        else:
            entries = {"k": k, "v": v, "kpos": kpos}
        if window:
            # copies: a view of the prompt's k / v (at batch 1 a slice is
            # contiguous) would keep all S positions alive in the cache
            return {name: t.clone() for name, t in entries.items()}
        length = max(cache_len, S)  # k and v hold this rank's kv heads
        cache = {}
        for name, t in entries.items():
            cache[name] = (torch.full((B, length), -1, dtype=torch.int32, device=k.device)
                           if name == "kpos" else t.new_zeros((B, length) + tuple(t.shape[2:])))
            cache[name][:, :S] = t
        return cache

    def _block_prefill(self, kind: str, lp, x, positions, cache_len: int, rules=None,
                       memory=None):
        """(the block's output, its cache; None for an ``enc`` block)."""
        cfg = self.cfg
        x = constrain(x, rules, ("batch", "seq", None))
        h = self._ln(lp["ln1"], x)
        if kind == "rwkv":
            t, shift_t, wkv = R.timemix_apply(lp["tm"], h, cfg, rules=rules)
            x = x + t
            c, shift_c = R.channelmix_apply(lp["cm"], self._ln(lp["ln2"], x), cfg=cfg,
                                            rules=rules)
            return x + c, {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}
        if kind == "rec":
            r, h_state, conv = G.rglru_block_apply(lp["rec"], h, cfg, rules=rules)
            return self._ffn_half(lp, x + r, rules)[0], {"h": h_state, "conv": conv}
        window = _window(cfg, kind)
        a, k, v = L.attention_prefill(lp["attn"], h, cfg, positions, window, rules,
                                      causal=kind != "enc", rope=not self.learned_pos)
        x = x + a
        if kind == "xattn":
            x = x + L.cross_attention(lp["xattn"], self._ln(lp["lnx"], x), memory, cfg, rules)
        cache = None if kind == "enc" else self._kv_cache(k, v, positions, window, cache_len)
        return self._ffn_half(lp, x, rules)[0], cache

    def _block_decode(self, kind: str, lp, x, cache, pos: int, rules=None, memory=None):
        cfg = self.cfg
        h = self._ln(lp["ln1"], x)
        if kind == "rwkv":
            t, cache["shift_t"], cache["wkv"] = R.timemix_apply(
                lp["tm"], h, cfg, cache["shift_t"], cache["wkv"], decode=True, rules=rules)
            x = x + t
            c, cache["shift_c"] = R.channelmix_apply(
                lp["cm"], self._ln(lp["ln2"], x), cache["shift_c"], cfg=cfg, rules=rules)
            return x + c
        if kind == "rec":
            r, cache["h"], cache["conv"] = G.rglru_block_apply(
                lp["rec"], h, cfg, cache["h"], cache["conv"], decode=True, rules=rules)
            return self._ffn_half(lp, x + r, rules)[0]
        x = x + L.attention_decode(lp["attn"], h, cfg, cache, pos, _window(cfg, kind), rules,
                                   rope=not self.learned_pos)
        if kind == "xattn":
            x = x + L.cross_attention(lp["xattn"], self._ln(lp["lnx"], x), memory, cfg, rules,
                                      decode=True)
        return self._ffn_half(lp, x, rules)[0]

    def _encode(self, params, frames, rules=None) -> torch.Tensor:
        """The encoder's memory (B, encoder_seq, d): the frames plus
        ``enc_pos``, the ``enc`` blocks, then ``enc_ln``. Missing frames
        raise ValueError."""
        cfg = self.cfg
        if frames is None:
            raise ValueError(f"{cfg.name}: the prefill and the loss of an encoder-decoder take "
                             f"frames (B, {cfg.encoder_seq}, {cfg.d_model})")
        dt = activation_dtype(cfg)
        frames = torch.as_tensor(frames).to(device=params["enc_pos"].device, dtype=dt)
        B, S, _ = frames.shape
        x = frames + params["enc_pos"][None, :S].to(dt)
        positions = torch.arange(S, dtype=torch.int32, device=frames.device).expand(B, S)
        for lp in params["encoder"]:
            x, _ = self._block_prefill("enc", lp, x, positions, S, rules)
        return self._ln(params["enc_ln"], x)

    def _inputs(self, params, tokens, pos0: int, rules=None, image_embeds=None) -> torch.Tensor:
        """The token embeddings, plus (whisper) the learned positions of
        positions pos0 .. pos0 + S - 1, every row's the same, after (a vision
        config) the image embeddings cast to the activation dtype."""
        x = self._embed(params, tokens, rules)
        if self.learned_pos:
            x = x + params["pos_embed"][pos0:pos0 + tokens.shape[1]].to(x.dtype)
        if self.image_tokens(image_embeds):
            img = torch.as_tensor(image_embeds).to(device=x.device, dtype=x.dtype)
            x = torch.cat([img, x], dim=1)
        return x

    def image_tokens(self, image_embeds) -> int:
        """The positions that ``image_embeds`` (B, P, d) add before the
        tokens in a prefill or a loss: P, or 0 without them or for a config
        without image tokens, which ignores them as the reference does."""
        return image_embeds.shape[1] if self.cfg.num_img_tokens and image_embeds is not None else 0

    def prefill(self, params, tokens: torch.Tensor, rules: Optional[MeshRules] = None,
                cache_len: Optional[int] = None, frames: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, S) int (with rules, this rank's data shard); an
        encoder-decoder also takes ``frames`` (B, encoder_seq, d), a vision
        config ``image_embeds`` (B, num_img_tokens, d), which make the
        sequence S_tot = S + num_img_tokens positions. Returns the last
        position's logits (B, vocab) and the per-layer caches (see
        ``_kv_cache`` for the attention layers, of max(cache_len, S_tot)
        slots; the recurrent layers keep their final states), then, for an
        encoder-decoder, {"memory"}."""
        _check_rules(rules)
        B, S = tokens.shape
        S += self.image_tokens(image_embeds)
        memory = self._encode(params, frames, rules) if self.cfg.encoder_layers else None
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = constrain(self._inputs(params, tokens, 0, rules, image_embeds), rules,
                      ("batch", "seq", None))
        caches = []
        for kind, lp in zip(self.kinds, params["layers"]):
            x, cache = self._block_prefill(kind, lp, x, positions, cache_len or S, rules, memory)
            caches.append(cache)
        if memory is not None:
            caches.append({"memory": memory})
        # the final norm is per row, so normalising only the last position
        # gives the reference's x[:, -1] after its full-sequence norm
        x = self._ln(params["final_ln"], x[:, -1:])
        return self._logits(params, x[:, 0], rules), caches

    def decode(self, params, tokens: torch.Tensor, pos: int, caches: List[Dict],
               rules: Optional[MeshRules] = None) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B, 1) int; pos: the position of every row (Python int).
        Updates each layer's cache in place and returns (logits (B, vocab),
        caches)."""
        _check_rules(rules)
        memory = caches[-1]["memory"] if self.cfg.encoder_layers else None
        x = self._inputs(params, tokens, pos, rules)
        for kind, lp, cache in zip(self.kinds, params["layers"], caches):
            x = self._block_decode(kind, lp, x, cache, pos, rules, memory)
        x = self._ln(params["final_ln"], x)
        return self._logits(params, x[:, 0], rules), caches

    # -- training -------------------------------------------------------------
    def _block_train(self, kind: str, lp, x, positions, rules=None, memory=None):
        """(the block's output, its MoE aux term or None); an ``xattn``
        block also attends to the encoder's ``memory``."""
        x = constrain(x, rules, ("batch", "seq", None))
        h = self._ln(lp["ln1"], x)
        # the recurrent kinds: the prefill's block from a zero state, no cache
        cfg = self.cfg
        if kind == "rwkv":
            x = x + R.timemix_apply(lp["tm"], h, cfg, rules=rules)[0]
            return x + R.channelmix_apply(lp["cm"], self._ln(lp["ln2"], x), cfg=cfg,
                                          rules=rules)[0], None
        if kind == "rec":
            return self._ffn_half(lp, x + G.rglru_block_apply(lp["rec"], h, cfg, rules=rules)[0],
                                  rules)
        x = x + L.attention_prefill(lp["attn"], h, cfg, positions, _window(cfg, kind), rules,
                                    rope=not self.learned_pos)[0]
        if kind == "xattn":
            x = x + L.cross_attention(lp["xattn"], self._ln(lp["lnx"], x), memory, cfg, rules)
        return self._ffn_half(lp, x, rules)

    def loss(self, params, batch, rules: Optional[MeshRules] = None) -> torch.Tensor:
        """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S) (an
        int array or tensor), as the reference's ``loss``: position t
        predicts token t + 1, the last slot is masked, the cross-entropy is
        taken over the vocabulary in chunks of CE_CHUNK positions, each
        recomputed in the backward (the reference's ``jax.checkpoint(piece)``),
        and with ``cfg.remat`` every block is recomputed in the backward too.
        An MoE model adds 0.01 x its aux term summed over the layers in
        order, as the reference does (its sum starts at 0.0, so this is the
        same float32 sum). A vision config's ``batch["image_embeds"]`` (B,
        num_img_tokens, d) are prepended, as in ``prefill``, and position
        num_img_tokens + t predicts token t + 1. An encoder-decoder's
        ``batch["frames"]`` (B, encoder_seq, d) are encoded as in
        ``prefill`` (a batch without them raises ValueError), its tokens
        get the learned positions 0..S-1, and each decoder block runs its
        causal self-attention, the cross-attention to the memory and the
        FFN. Attention, wkv6, the RG-LRU scan and the norms run the CUDA
        kernels, forward and backward, on the card.

        With rules ``batch`` is this rank's data shard, and the returned loss
        is the global batch's on every rank: the cross-entropy's sum and its
        count are summed over the data axes (a sum whose gradient is the
        identity, so each rank's backward gives its shard's part of every
        gradient; ``train.step`` sums the parts)."""
        _check_rules(rules)
        memory = self._encode(params, batch.get("frames"), rules) if self.cfg.encoder_layers \
            else None
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"]).to(device=embed.device, dtype=torch.int64)
        image_embeds = batch.get("image_embeds")
        P_img = self.image_tokens(image_embeds)
        B, S = tokens.shape
        positions = torch.arange(S + P_img, dtype=torch.int32,
                                 device=embed.device).expand(B, S + P_img)
        x = constrain(self._inputs(params, tokens, 0, rules, image_embeds), rules,
                      ("batch", "seq", None))
        aux = None
        for kind, lp in zip(self.kinds, params["layers"]):
            if self.cfg.remat:
                x, a = checkpoint(self._block_train, kind, lp, x, positions, rules, memory,
                                  use_reentrant=False)
            else:
                x, a = self._block_train(kind, lp, x, positions, rules, memory)
            if a is not None:
                aux = a if aux is None else aux + a
        x = self._ln(params["final_ln"], x[:, P_img:])
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones((B, S), dtype=torch.float32, device=embed.device)
        mask[:, -1] = 0.0
        ce = _chunked_ce(x, self._head(params, x.dtype), labels, mask, rules,
                         self._vocab_split(params, rules))
        return ce if aux is None else ce + 0.01 * aux

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
        """Empty caches for a fresh sequence of up to ``seq_len`` positions
        (and an encoder-decoder's zero memory)."""
        cfg = self.cfg
        dt = activation_dtype(cfg)
        caches = [self._block_cache(kind, B, seq_len, dt, device) for kind in self.kinds]
        if cfg.encoder_layers:
            caches.append({"memory": torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                                 device=device)})
        return caches


def _check_rules(rules: Optional[MeshRules]) -> None:
    """The port's steps keep every position of a sequence on each rank:
    rules that split the residual stream's "seq" dim (the dry run's
    sequence-parallel overrides) raise."""
    if rules is not None and any(c is not None for c in rules.overrides.get("seq") or ()):
        raise NotImplementedError(
            f"rules that split 'seq' ({rules.overrides['seq']}): sequence parallelism of the "
            f"residual stream is not ported yet (ROADMAP.md Queue 1, item 9.8)")


def _ce_piece(hc, head, lc, mc, rules=None, vocab: Optional[tp.Split] = None):
    logits = constrain(hc @ head, rules, ("batch", None, "vocab")).to(torch.float32)  # (B, c, V)
    if vocab is None:
        lz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum((lz - ll) * mc)
    # this rank's columns of the vocabulary: the max, the sum of exponentials
    # and the label's logit over "model" (the max is a constant of the
    # log-sum-exp, so its gradient is zero: detached)
    mesh, V = vocab.mesh, logits.shape[-1]
    mx = C.pmax(logits.detach().amax(dim=-1), mesh, "model")
    lz = mx + torch.log(C.psum(torch.exp(logits - mx[..., None]).sum(dim=-1), mesh, "model"))
    local = lc - tp.offset(vocab, V)
    inside = (local >= 0) & (local < V)
    local = torch.where(inside, local, torch.zeros_like(local))
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    ll = C.psum(torch.where(inside, picked, torch.zeros_like(lz)), mesh, "model")
    return torch.sum((lz - ll) * mc)


def _chunked_ce(h, head, labels, mask, rules: Optional[MeshRules] = None,
                vocab: Optional[tp.Split] = None) -> torch.Tensor:
    """sum over chunks of CE_CHUNK positions of the masked cross-entropy,
    each chunk under ``torch.utils.checkpoint``, divided by the mask's sum
    (at least 1): the (B, S, vocab) logits are never all held at once. With
    rules the sum and the mask's sum are the global batch's (summed over
    the data axes), and with ``vocab`` (the head's "model"-axis split)
    ``head`` holds this rank's columns of the vocabulary."""
    T = h.shape[1]
    c = min(CE_CHUNK, T)
    while T % c:
        c //= 2
    h = tp.vary(vocab, h)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, c):
        total = total + checkpoint(_ce_piece, h[:, i:i + c], head, labels[:, i:i + c],
                                   mask[:, i:i + c], rules, vocab, use_reentrant=False)
    count = mask.sum()
    if rules is not None:
        total = C.psum(total, rules.mesh, rules.data_axes)
        count = C.psum(count, rules.mesh, rules.data_axes)
    return total / torch.clamp(count, min=1.0)


def build_model(cfg: ArchConfig) -> ModelDef:
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} {_LATER}")
    return ModelDef(cfg=cfg)
