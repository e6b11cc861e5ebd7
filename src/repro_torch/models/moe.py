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

The reference's expert-parallel path (``moe_apply_manual``) needs a mesh;
``moe_impl="manual"`` raises here (ROADMAP.md Queue 1, item 9.5).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import INIT_STD, _normal

MANUAL = ("moe_impl='manual' (expert parallelism over a mesh, the reference's "
          "moe_apply_manual) is not ported: it needs a mesh (ROADMAP.md Queue 1, item 9.5)")

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
        """The slots past their expert's capacity: () int64."""
        return torch.sum(self.slot_row == self.row_slot.numel())


def route(p: Params, x: torch.Tensor, cfg) -> Tuple[Plan, torch.Tensor]:
    """The router: (the dispatch plan, the aux loss (float32 scalar)).
    x: (B, S, d), each batch row a group."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    logits = x @ p["router"].to(dt)  # (B, S, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    aux = _switch_aux(probs)

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


def _switch_aux(probs: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance term over the whole batch's float32
    probabilities (..., E): E * sum(mean prob * top-1 share)."""
    E = probs.shape[-1]
    me = torch.mean(probs.reshape(-1, E), dim=0)
    top1 = torch.argmax(probs, dim=-1).reshape(-1)  # the first maximum, as jnp.argmax
    ce = torch.mean(F.one_hot(top1, E).to(torch.float32), dim=0)
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


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    sp, dt = p["shared"], x.dtype
    return (F.silu(x @ sp["wg"].to(dt)) * (x @ sp["wu"].to(dt))) @ sp["wo"].to(dt)


def moe_apply(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss (float32 scalar)). The auto
    path; ``moe_impl="manual"`` raises NotImplementedError."""
    if cfg.moe_impl == "manual":
        raise NotImplementedError(f"{cfg.name}: {MANUAL}")
    return moe_apply_auto(p, x, cfg)


def moe_apply_auto(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply_auto``: groups are batch rows."""
    B, S, d = x.shape
    plan, aux = route(p, x, cfg)
    y = combine(expert_ffn(p, dispatch(x, plan)), plan).view(B, S, d)
    if cfg.n_shared_experts:
        y = y + _shared(p, x)
    return y, aux


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
