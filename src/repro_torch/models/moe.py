"""Mixture-of-experts FFN with capacity dispatch (counterpart of
``repro/models/moe.py``): token-choice top-k routing, each token's slots
dispatched into per-expert capacity buffers, a batched expert FFN, and a
gate-weighted combine. The arithmetic is the reference's auto path
(``moe_apply_auto``), step by step:

- *Groups.* A group is one batch row, in prefill, in training and in
  decode. A decode step's ``x`` is (B, 1, d), so each group is one token.
  (The reference's docstring says decode reshapes to (1, B, d); its code
  does not, and the port follows the code.)
- *Capacity.* C = max(ceil(k * S * capacity_factor / E), 1) slots an
  expert a group, in Python floats: 80 at olmoe's S 512, 1 in decode.
- *Top-k.* On the probabilities cast to the activation dtype, by a stable
  descending sort: among equal probabilities (common in bf16 with 64
  experts) the lower expert index comes first, as ``jax.lax.top_k`` puts
  it. The k gates are renormalised over their sum in the activation dtype.
- *Dispatch.* The group's (token, expert) slots sorted by expert, stably,
  so an expert's slots keep token order; the slot at position p of its
  expert goes to buffer row p, and a slot at p >= C is dropped: it
  contributes zero.
- *Combine.* A token's kept slots summed in ascending expert id, each add
  rounded to the activation dtype: the order in which the reference's
  scatter-add visits them.
- *Aux loss.* The Switch load-balance term over float32 probabilities of
  the whole batch: E * sum(mean prob * top-1 share), the top-1 the first
  maximum.

Determinism. The FT trainer's final state must be bit-identical to a
failure-free run's, so the forward and backward give the same bits on
every call. CUDA's backward of ``index_add_``, ``scatter_add_``,
``index_put_(accumulate=True)`` and of an indexed read sums colliding
rows with atomics, in no fixed order. Dispatch and combine are therefore
reads through two integer tables (:class:`Plan`): the slot that fills each
buffer row, and the buffer row of each of a token's k slots, each with a
zero row as sentinel. Each is an autograd Function whose backward is
again a read through the other table, with the sum over a token's k slots
taken in a fixed order. The expert FFN is three batched matrix products
(``torch.bmm``) over the (E, B * C, d) buffer.

The expert-parallel path (``moe_apply_manual``, the reference's
``shard_map`` body run on each rank's local shards): the tokens of a data
shard in one group, each "model" rank building the capacity buffers of its
own E / n_model experts through the same two-table dispatch and combine,
the partial outputs summed over "model" once a layer
(:mod:`repro_torch.sharding.collectives`). ``moe_apply`` takes it as the
reference's dispatcher does: ``moe_impl="manual"``, rules over a mesh with a
"model" axis that divides the experts.

The auto path under ``rules`` holds the experts as the rules lay them out
(:mod:`repro_torch.sharding.tp`): each "model" rank the E / n_model
experts of its block. The router, ``top_k``'s tie order, the capacity and
the drops stay global: every rank routes the whole batch alike, then
builds only its experts' buffer rows (:func:`local_plan`), and the combine
of its experts' slots is a part summed over "model".
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import INIT_STD, _normal
from repro_torch.sharding import collectives as C
from repro_torch.sharding import fsdp, tp
from repro_torch.sharding.rules import MeshRules, constrain

Params = Dict[str, torch.Tensor]


def moe_init(gen, cfg, device, dtype) -> Params:
    """The router (d, E) and the experts' wg, wu (E, d, f) and wo (E, f, d),
    normal with std 0.02; with ``cfg.n_shared_experts`` a dense swiglu
    ``shared`` sub-tree of width f * n_shared_experts."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _normal(gen, (d, E), INIT_STD, device, dtype),
        "wg": _normal(gen, (E, d, f), INIT_STD, device, dtype),
        "wu": _normal(gen, (E, d, f), INIT_STD, device, dtype),
        "wo": _normal(gen, (E, f, d), INIT_STD, device, dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "wg": _normal(gen, (d, fs), INIT_STD, device, dtype),
            "wu": _normal(gen, (d, fs), INIT_STD, device, dtype),
            "wo": _normal(gen, (fs, d), INIT_STD, device, dtype),
        }
    return p


def moe_axes(cfg) -> Dict:
    """The logical axes of ``moe_init``'s leaves (the reference's)."""
    ax = {"router": ("embed", None), "wg": ("expert", "embed", "expert_mlp"),
          "wu": ("expert", "embed", "expert_mlp"), "wo": ("expert", "expert_mlp", "embed")}
    if cfg.n_shared_experts:
        ax["shared"] = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return ax


def capacity(cfg, group_size: int) -> int:
    """Slots an expert a group (the reference's ``_group_dispatch``)."""
    return max(int(math.ceil(cfg.top_k * group_size * cfg.capacity_factor / cfg.n_experts)), 1)


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values along the last axis, largest
    first and, among equal values, the lower index first (a stable
    descending sort), as ``jax.lax.top_k`` orders them. ``torch.topk``
    leaves the order of ties open."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


@dataclass
class Plan:
    """One batch's routing. Slots are token-major, a token's k slots in
    ascending expert id; buffer rows are laid out (E, B, C), so that the
    buffer reads as (E, B * C, d) for the expert products.

    gates: (T, k) the renormalised gates of the slots, in the activation
      dtype (differentiable);
    slot_row: (T, k) int64, the buffer row of each slot; R (the zero row)
      for a dropped slot;
    row_slot: (R,) int64, the slot that fills each buffer row; T * k (the
      zero row) for an empty one."""

    gates: torch.Tensor
    slot_row: torch.Tensor
    row_slot: torch.Tensor
    n_experts: int
    capacity: int

    @property
    def dropped(self) -> torch.Tensor:
        """The slots past their expert's capacity (on the manual path, also
        the slots of other ranks' experts): () int64."""
        return torch.sum(self.slot_row == self.row_slot.numel())


def route(p: Params, x: torch.Tensor, cfg, rules: Optional[MeshRules] = None
          ) -> Tuple[Plan, torch.Tensor]:
    """The router: (the dispatch plan, the aux loss (float32 scalar)).
    x: (B, S, d), each batch row a group."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    logits = x @ p["router"].to(dt)  # (B, S, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    aux = _switch_aux(probs, rules)

    probs_dt = probs.to(dt)
    idx = top_k(probs_dt.detach(), k)  # (B, S, k), largest first
    gate_vals = torch.gather(probs_dt, -1, idx)
    # renormalised over the selected experts, in the activation dtype
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # a token's slots in ascending expert id from here on: the combine's
    # order; an expert's slots keep token order either way, so the dispatch
    # is the reference's. (The gathers' backward writes k distinct
    # positions a token, each once.)
    idx, perm = torch.sort(idx, dim=-1)
    gates = torch.gather(gate_vals, -1, perm).reshape(B * S, k)

    C = capacity(cfg, S)
    n = S * k
    dev = x.device
    flat_e = idx.reshape(B, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # slots by expert, token order kept
    se = torch.gather(flat_e, 1, order)
    # each expert's first sorted slot; a slot's position within its expert
    starts = torch.searchsorted(se, torch.arange(E, device=dev).expand(B, E).contiguous())
    pos = torch.arange(n, device=dev)[None] - torch.gather(starts, 1, se)
    keep = pos < C
    R = E * B * C
    b = torch.arange(B, device=dev)[:, None]
    row_sorted = torch.where(keep, se * (B * C) + b * C + pos, R)
    slot_sorted = b * n + order  # the global slot of each sorted slot
    # ``order`` is a permutation of the group's slots: each entry written once
    slot_row = torch.empty_like(order).scatter_(1, order, row_sorted)
    # a dropped slot writes an entry of its own past R, so no two writes meet
    dest = torch.where(keep, row_sorted, R + slot_sorted)
    row_slot = torch.full((R + B * n,), B * n, dtype=torch.int64, device=dev)
    row_slot = row_slot.scatter_(0, dest.reshape(-1), slot_sorted.reshape(-1))[:R]
    plan = Plan(gates=gates, slot_row=slot_row.reshape(B * S, k), row_slot=row_slot,
                n_experts=E, capacity=C)
    return plan, aux


def _switch_aux(probs: torch.Tensor, rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Switch-style load-balance term over the whole batch's float32
    probabilities (..., E): E * sum(mean prob * top-1 share). With rules the
    batch is this rank's data shard, and both means are taken over the
    global batch (averaged over the equal data shards) before the product."""
    E = probs.shape[-1]
    me = torch.mean(probs.reshape(-1, E), dim=0)
    top1 = torch.argmax(probs, dim=-1).reshape(-1)  # the first maximum, as jnp.argmax
    ce = torch.mean(F.one_hot(top1, E).to(torch.float32), dim=0)
    if rules is not None:
        me = C.pmean(me, rules.mesh, rules.data_axes)
        ce = C.pmean(ce, rules.mesh, rules.data_axes)
    return E * torch.sum(me * ce)


def _with_zero_row(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])])


def _sum_slots(rows: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): the k rows added in order, each add in their
    dtype (the reference's scatter-add order and rounding)."""
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """x2 (T, d) -> buffer (R, d): row r holds the token of slot
    ``row_slot[r]``, or zeros. Backward: a token's gradient is the sum of its
    k slots' rows, in ascending expert id."""

    @staticmethod
    def forward(ctx, x2, row_slot, slot_row):
        ctx.save_for_backward(slot_row)
        k = slot_row.shape[1]
        return _with_zero_row(x2)[torch.div(row_slot, k, rounding_mode="floor")]

    @staticmethod
    def backward(ctx, dbuf):
        (slot_row,) = ctx.saved_tensors
        return _sum_slots(_with_zero_row(dbuf)[slot_row]), None, None


class _Combine(torch.autograd.Function):
    """buffer (R, d), gates (T, k) -> y (T, d): sum_j gates[t, j] *
    buffer[slot_row[t, j]], j in ascending expert id. Backward: a buffer
    row's gradient is its slot's gate times its token's dy (one read), a
    gate's the dot product of dy with its row, in float32."""

    @staticmethod
    def forward(ctx, ob, gates, slot_row, row_slot):
        rows = _with_zero_row(ob)[slot_row]  # (T, k, d)
        ctx.save_for_backward(rows, gates, row_slot)
        return _sum_slots(rows * gates[..., None])

    @staticmethod
    def backward(ctx, dy):
        rows, gates, row_slot = ctx.saved_tensors
        k = gates.shape[1]
        g_row = _with_zero_row(gates.reshape(-1, 1))[row_slot]  # (R, 1); 0 for an empty row
        d_ob = _with_zero_row(dy)[torch.div(row_slot, k, rounding_mode="floor")] * g_row
        d_g = torch.sum(rows.to(torch.float32) * dy.to(torch.float32)[:, None], dim=-1)
        return d_ob, d_g.to(gates.dtype), None, None


def dispatch(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """x (B, S, d) -> the capacity buffer (E, B * C, d)."""
    d = x.shape[-1]
    buf = _Dispatch.apply(x.reshape(-1, d), plan.row_slot, plan.slot_row)
    return buf.view(plan.n_experts, -1, d)


def expert_ffn(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's swiglu on its buffer rows: (E, n, d) -> (E, n, d)."""
    dt = buf.dtype
    h = torch.bmm(buf, p["wg"].to(dt))
    u = torch.bmm(buf, p["wu"].to(dt))
    return torch.bmm(F.silu(h) * u, p["wo"].to(dt))


def combine(out_buf: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The expert outputs (E, B * C, d) -> (T, d), gate-weighted."""
    d = out_buf.shape[-1]
    return _Combine.apply(out_buf.reshape(-1, d), plan.gates, plan.slot_row, plan.row_slot)


def local_plan(plan: Plan, first: int, n_local: int) -> Plan:
    """``plan`` (global: buffer rows (E, B, C)) restricted to the experts
    ``first .. first + n_local - 1``: their block of buffer rows, and each
    slot's row within it, or the zero row for a slot of another expert."""
    per = plan.row_slot.numel() // plan.n_experts  # B * C rows an expert
    lo, R = first * per, n_local * per
    rel = plan.slot_row - lo
    slot_row = torch.where((rel >= 0) & (rel < R), rel, torch.full_like(rel, R))
    return Plan(gates=plan.gates, slot_row=slot_row, row_slot=plan.row_slot[lo:lo + R],
                n_experts=n_local, capacity=plan.capacity)


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    sp, dt = p["shared"], x.dtype
    return (F.silu(x @ sp["wg"].to(dt)) * (x @ sp["wu"].to(dt))) @ sp["wo"].to(dt)


def uses_manual(cfg, rules: Optional[MeshRules]) -> bool:
    """Whether ``moe_apply`` takes the expert-parallel path (the reference's
    dispatcher): ``moe_impl="manual"``, rules, a "model" axis, and E a
    multiple of its size."""
    return (cfg.moe_impl == "manual" and rules is not None and "model" in rules.axes
            and cfg.n_experts % rules.axes["model"] == 0)


def moe_apply(p: Params, x: torch.Tensor, cfg, rules: Optional[MeshRules] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss (float32 scalar)): the manual
    path where ``uses_manual``, else the auto path."""
    if uses_manual(cfg, rules):
        return moe_apply_manual(p, x, cfg, rules)
    return moe_apply_auto(p, x, cfg, rules)


def moe_apply_auto(p: Params, x: torch.Tensor, cfg, rules: Optional[MeshRules] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply_auto``: groups are batch rows. With rules
    ``x`` is this rank's data shard, the experts are this rank's block of
    the "expert" dim (``local_plan``; whole where it does not split) and the
    shared expert its columns, and the aux term is the global batch's."""
    B, S, d = x.shape
    plan, aux = route(p, x, cfg, rules)
    s = tp.split(rules, p["wg"].shape[0], cfg.n_experts)
    if s is not None:  # the router's work is every rank's alike; the rest a part
        n_local = p["wg"].shape[0]
        plan = local_plan(plan, tp.offset(s, n_local), n_local)
        plan.gates = tp.vary(s, plan.gates)
    buf = dispatch(tp.vary(s, x), plan)
    constrain(buf.view(plan.n_experts, B, plan.capacity, d), rules,
              ("expert", "batch", None, None))
    y = tp.psum(s, combine(expert_ffn(p, buf), plan).view(B, S, d))
    if cfg.n_shared_experts:
        s2 = tp.split(rules, p["shared"]["wo"].shape[0], cfg.d_ff * cfg.n_shared_experts)
        y = y + tp.psum(s2, _shared(p, tp.vary(s2, x)))
    return constrain(y, rules, ("batch", None, None)), aux


def _entry(axes: Tuple[str, ...]):
    return None if not axes else axes[0] if len(axes) == 1 else axes


def manual_specs(cfg, rules: MeshRules) -> Dict:
    """How the manual path takes each of the layer's leaves over the mesh
    (the reference's ``in_specs``): the router whole; the experts split
    over "model" (and, with ``cfg.fsdp``, their d or f dim over the data
    axes); the shared expert column-parallel over "model"."""
    fs = _entry(rules.data_axes) if cfg.fsdp else None
    specs = {"router": (None, None), "wg": ("model", fs, None), "wu": ("model", fs, None),
             "wo": ("model", None, fs)}
    if cfg.n_shared_experts:
        specs["shared"] = {"wg": (None, "model"), "wu": (None, "model"), "wo": ("model", None)}
    return specs


def manual_plan(probs: torch.Tensor, dt, cfg, first: int, n_local: int, cap: int) -> Plan:
    """The manual path's index-only plan over one group of T tokens, for
    the experts ``first .. first + n_local - 1``: probs (T, E) float32.
    Slots are token-major in top-k order (the combine adds a token's k
    reads in that order, as the reference does); buffer rows are (n_local,
    cap). A slot of another rank's expert, or past its expert's capacity,
    reads the zero row (``Plan.dropped`` counts both)."""
    T, E = probs.shape
    k = cfg.top_k
    probs_dt = probs.to(dt)
    idx = top_k(probs_dt.detach(), k)  # (T, k), largest first
    gate_vals = torch.gather(probs_dt, -1, idx)
    gates = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    n, dev = T * k, probs.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # slots by expert, token order kept
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(n, device=dev) - starts[se]
    rel = se - first
    keep = (rel >= 0) & (rel < n_local) & (pos < cap)
    R = n_local * cap
    dest = torch.where(keep, rel * cap + pos, R)
    # ``order`` is a permutation of the slots: each entry written once
    slot_row = torch.empty_like(order).scatter_(0, order, dest)
    # a slot not kept writes an entry of its own past R, so no two writes meet
    row_slot = torch.full((R + n,), n, dtype=torch.int64, device=dev)
    row_slot = row_slot.scatter_(0, torch.where(keep, dest, R + torch.arange(n, device=dev)),
                                 order)[:R]
    return Plan(gates=gates, slot_row=slot_row.view(T, k), row_slot=row_slot, n_experts=n_local,
                capacity=cap)


def moe_apply_manual(p: Params, x: torch.Tensor, cfg, rules: MeshRules
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over "model": the reference's ``shard_map`` body,
    run on this rank's local shards. ``x`` is this rank's data shard (B_loc,
    S, d), the same on every "model" rank (or its sequence block under the
    sequence-parallel override ``seq -> model``, gathered at entry); ``p``
    holds the leaves as ``manual_specs`` lays them out, or its experts whole
    over the data axes (the model's blocks gather every leaf that the
    rules lay there: ``sharding/fsdp.py``). The rank's T = B_loc
    S tokens form one group of capacity C = ceil(k T capacity_factor / E);
    each rank computes its E / n_model experts' slots and the shared
    expert's columns, and the partial outputs are summed over "model" once
    (or sum-scattered back onto the sequence blocks). Experts that arrive
    split over the data axes are gathered just in time; their gradients
    reduce-scatter in the gather's backward. The aux
    term is the mean over the data shards of each shard's term. Returns (y
    (B_loc, S, d) or its sequence block, aux)."""
    mesh, data = rules.mesh, rules.data_axes
    n_model = rules.axes["model"]
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // n_model
    if p["wg"].shape[0] != E_loc:
        raise ValueError(f"moe_apply_manual: experts {tuple(p['wg'].shape)} where this rank "
                         f"holds {E_loc} of {E} (see manual_specs)")
    sp = "model" in tuple(rules.overrides.get("seq") or ())
    # tokens every "model" rank holds alike: each rank's gradient is a part
    x = C.all_gather(x, mesh, "model", dim=1) if sp else C.pvary(x, mesh, "model")
    B, S, d = x.shape
    T, dt = B * S, x.dtype
    xs = x.reshape(T, d)
    logits = xs @ C.pvary(p["router"], mesh, "model").to(dt)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    aux = C.pmean(C.pmean(_switch_aux(probs), mesh, data), mesh, "model")
    cap = int(math.ceil(k * T * cfg.capacity_factor / E))
    plan = manual_plan(probs, dt, cfg, C.axis_index(mesh, "model") * E_loc, E_loc, cap)
    d, f = cfg.d_model, cfg.d_ff
    specs = manual_specs(cfg, rules)
    # an expert leaf split over the data axes (``manual_specs`` with
    # ``cfg.fsdp``) is gathered here; the model's blocks pass them whole
    w = {name: p[name] if tuple(p[name].shape[1:]) == whole else
         fsdp.gather_leaf(p[name], specs[name], rules)
         for name, whole in (("wg", (d, f)), ("wu", (d, f)), ("wo", (f, d)))}
    y = combine(expert_ffn(w, dispatch(xs, plan)), plan)
    if cfg.n_shared_experts:  # column-parallel: a part of the sum over "model"
        y = y + _shared(p, xs)
    y = y.view(B, S, d)
    if sp:  # combine and re-split the sequence in one collective
        return C.psum_scatter(y, mesh, "model", dim=1), aux
    return C.psum(y, mesh, "model"), aux


def moe_ref(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Dense oracle (the reference's ``moe_ref``): every expert on every
    token, masked by the top-k gates, chosen over float32 probabilities; no
    capacity. O(T E d f): only to hold the dispatch path against (the tests,
    and ``chip_smoke.py`` once at full width)."""
    k, dt = cfg.top_k, x.dtype
    logits = x @ p["router"].to(dt)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = top_k(probs, k)
    gate_vals = torch.gather(probs, -1, idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    gates = torch.zeros(probs.shape, dtype=torch.float32, device=x.device).scatter_(
        -1, idx, gate_vals)
    h = torch.einsum("bsd,edf->bsef", x, p["wg"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, p["wu"].to(dt))
    o = torch.einsum("bsef,efd->bsed", F.silu(h) * u, p["wo"].to(dt))
    y = torch.einsum("bsed,bse->bsd", o, gates.to(dt))
    if cfg.n_shared_experts:
        y = y + _shared(p, x)
    return y
