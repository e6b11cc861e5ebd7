"""Optimizers in plain tensor ops (counterpart of ``repro/train/optim.py``):
AdamW, Adafactor (factored second moments) and momentum SGD, and int8
gradient compression with error feedback.

Each optimizer is (init_fn, update_fn):
  state = init(params)
  params, state = update(params, grads, state, step)

The reference's state mirrors its parameter tree, in which each block's
weights are stacked along a leading repeat axis; Adafactor's factored
statistics and update clipping and the compression's int8 scale are taken
over such a stacked leaf, across the layers of a stack. The port keeps one
parameter dict per layer, so given ``stacks`` (the model's ``(unit,
repeats)`` list, ``models.model_api._stacks_for``) it groups its per-layer
tensors into the reference's leaves (:func:`leaf_groups`), and the optimizer
state and the error feedback keep the reference's layout: nested dicts
under the reference's paths (``embed``, ``final_ln/scale``,
``stack0/b0/attn/wq``, ...) with its stacked shapes.

``update`` and the compression write their results into the parameter,
state and error-feedback tensors they are given (the reference's are
pure): a full-width AdamW state (~30 GB for gemma-2b) does not fit on the
card twice. The arithmetic is the reference's, operation by operation, in
float32; Adafactor's statistics over a large leaf are summed in pieces
(``PIECE``), in another order.

Under ``MeshRules`` each rank holds its block of every leaf and of its
state (``train.step.state_specs``), and ``layouts`` (:class:`LeafLayout`,
one a reference leaf) say how. AdamW and momentum SGD are elementwise.
Adafactor's statistics and the compression's scale are taken over the
whole leaf, as the reference takes them: a row mean over the last dim is
the mean of the ranks' row means over that dim's axes, a column mean and
``vr``'s mean likewise over the second-to-last dim's, the clipping RMS over
every axis the leaf lies on, and the int8 scale a maximum over them. Each
such reduction crosses the ranks once a leaf, for all its layers and
pieces at once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import Spec, entry_axes
from repro_torch.utils.tree import tree_map

F32 = torch.float32
Path = Tuple[str, ...]
Stacks = Sequence[Tuple[Tuple[str, ...], int]]


@dataclass
class LeafLayout:
    """How one of the reference's leaves lies over the mesh under ``rules``:
    ``spec`` its spec (a stacked leaf's with its repeat dim whole) and
    ``state`` the spec of each of its optimizer-state leaves as the train
    state holds them (Adafactor's ``vr`` / ``vc`` by the axes left after
    their reduction, which may split a dim that the leaf holds whole). The
    default, no rules, is a leaf whole on one rank: every reduction is
    local."""

    rules: Any = None
    spec: Spec = ()
    state: Dict[str, Spec] = field(default_factory=dict)

    def axes(self, dim: Optional[int] = None) -> Tuple[str, ...]:
        """The mesh axes of the leaf's ``dim``, or of every dim, in mesh
        order."""
        if self.rules is None:
            return ()
        entries = self.spec if dim is None else (self.spec[dim],)
        used = {a for e in entries for a in entry_axes(e)}
        return tuple(a for a in self.rules.axes if a in used)

    def size(self, axes: Tuple[str, ...]) -> int:
        return self.rules.axis_size(axes) if axes else 1

    def psum(self, ts: List[torch.Tensor], axes: Tuple[str, ...]) -> List[torch.Tensor]:
        """Each of ``ts`` summed over the ranks of ``axes``, in one
        collective for all of them."""
        if not axes:
            return ts
        flat = C.psum(torch.cat([t.reshape(-1) for t in ts]), self.rules.mesh, axes)
        return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in ts]), ts)]

    def mean(self, ts: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
        """The ranks' means over their blocks of the leaf's ``dim`` (equal
        blocks) -> the means over the whole dim."""
        axes = self.axes(dim)
        return ts if not axes else [t / self.size(axes) for t in self.psum(ts, axes)]

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        axes = self.axes()
        return t if not axes else C.pmax(t, self.rules.mesh, axes)

    def _own(self, key: str, ndim: int) -> Spec:
        """The layout in which the update computes the state leaf ``key``:
        the leaf's spec without the dim that the statistic reduces."""
        if key == "vr":
            return self.spec[:-1]
        if key == "vc":
            return self.spec[:-2] + self.spec[-1:]
        return self.spec if len(self.spec) == ndim else (None,) * ndim

    def _relayout(self, t: torch.Tensor, src: Spec, dst: Spec) -> torch.Tensor:
        """``t``, this rank's block under ``src``, as its block under ``dst``:
        each dim where they differ gathered over ``src``'s axes, then cut by
        ``dst``'s (``t`` itself where they agree)."""
        dims = [i for i, (a, b) in enumerate(zip(src, dst)) if a != b]
        if not dims:
            return t
        for i in dims:
            if src[i] is not None:
                t = C.all_gather(t, self.rules.mesh, entry_axes(src[i]), i)
        return self.rules.local_shard(t, tuple(dst[i] if i in dims else None
                                               for i in range(t.dim())))

    def state_in(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The state leaf ``key`` as the update computes it."""
        if self.rules is None:
            return t
        return self._relayout(t, self.state[key], self._own(key, t.dim()))

    def state_out(self, key: str, stored: torch.Tensor, t: torch.Tensor) -> None:
        """Writes the updated state leaf ``t`` (from ``state_in``) back into
        the train state's ``stored``."""
        if t is not stored:
            stored.copy_(self._relayout(t, self._own(key, t.dim()), self.state[key]))


_LOCAL = LeafLayout()


def _paths(node, path: Path = ()):
    """(path, leaf) of every leaf under ``node``, dict keys sorted. A tuple is
    a leaf (the logical axes or the spec of a parameter: the parameter
    trees hold dicts and lists only)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], path + (k,))
    elif isinstance(node, list):
        for i, child in enumerate(node):
            yield from _paths(child, path + (str(i),))
    else:
        yield path, node


def _get(tree, path: Path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _set(tree: Dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def leaf_groups(params, stacks: Stacks) -> List[Tuple[Path, List[torch.Tensor], bool]]:
    """The reference's leaves as groups of the port's tensors: (path,
    tensors, stacked). ``params["layers"]`` is split into the stacks'
    repeats and each block's leaf is grouped over the repeats
    (``stack{i}/b{j}/...``, stacked), an encoder-decoder's
    ``params["encoder"]`` over its layers (``encoder/b0/...``, stacked);
    every other leaf is a group of one."""
    out = [(p, [t], False) for p, t in _paths({k: v for k, v in params.items()
                                               if k not in ("layers", "encoder")})]
    first = 0
    for si, (unit, reps) in enumerate(stacks):
        n = len(unit)
        for j in range(n):
            layers = [params["layers"][first + r * n + j] for r in range(reps)]
            for sub, _ in _paths(layers[0]):
                out.append(((f"stack{si}", f"b{j}") + sub, [_get(lp, sub) for lp in layers], True))
        first += reps * n
    if "encoder" in params:
        layers = params["encoder"]
        out += [(("encoder", "b0") + sub, [_get(lp, sub) for lp in layers], True)
                for sub, _ in _paths(layers[0])]
    return out


def _zeros_like_group(ts: List[torch.Tensor], stacked: bool, shape_fn=lambda s: s):
    shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
    return torch.zeros(shape_fn(shape), dtype=F32, device=ts[0].device)


def _state_tree(params, stacks: Stacks, make) -> Dict[str, Any]:
    st: Dict[str, Any] = {}
    for path, ts, stacked in leaf_groups(params, stacks):
        _set(st, path, make(ts, stacked))
    return st


def _pairs(params, grads, stacks: Stacks):
    """(path, params of the group, grads of the group, stacked)."""
    for (path, ps, stacked), (gpath, gs, _) in zip(leaf_groups(params, stacks),
                                                   leaf_groups(grads, stacks)):
        assert path == gpath, (path, gpath)
        yield path, ps, gs, stacked


def _stepf(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32) + 1.0


def make_optimizer(kind: str, stacks: Stacks, lr: float = 1e-4,
                   layouts: Optional[Dict[Path, LeafLayout]] = None, **kw):
    """(init, update) of ``kind``; ``layouts`` (by reference path) where the
    parameters are this rank's blocks under rules (the elementwise
    optimizers do not read them)."""
    if kind == "adamw":
        return _adamw(lr, stacks, **kw)
    if kind == "adafactor":
        return _adafactor(lr, stacks, layouts, **kw)
    if kind == "sgdm":
        return _sgdm(lr, stacks, **kw)
    raise ValueError(kind)


def _adamw(lr, stacks, b1=0.9, b2=0.95, eps=1e-8, wd=0.01):
    def init(params):
        return _state_tree(params, stacks, lambda ts, stacked: {
            "m": _zeros_like_group(ts, stacked), "v": _zeros_like_group(ts, stacked)})

    def update(params, grads, state, step):
        stepf = _stepf(step)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        for path, ps, gs, stacked in _pairs(params, grads, stacks):
            s = _get(state, path)
            for r, (p, g) in enumerate(zip(ps, gs)):
                m, v = (s["m"][r], s["v"][r]) if stacked else (s["m"], s["v"])
                gf = g.to(F32)
                m2 = b1 * m + (1 - b1) * gf
                v2 = b2 * v + (1 - b2) * gf * gf
                u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * p.to(F32)
                p.copy_((p.to(F32) - lr * u).to(p.dtype))
                m.copy_(m2)
                v.copy_(v2)
        return params, state

    return init, update


#: the most elements of a leaf that Adafactor's update holds in float32
#: temporaries at once: a larger leaf is updated a block of rows at a time
#: (kimi-k2's (E, 7168, 2048) expert leaves are 5.64 G elements a layer)
PIECE = 1 << 27


def _row_blocks(t: torch.Tensor, piece: int):
    """Index tuples that cut ``t`` into blocks of whole rows (its
    second-to-last axis) of at most ``piece`` elements, one row at least;
    a 1-D ``t`` is one block."""
    if t.dim() < 2:
        return [(Ellipsis,)]
    R = t.shape[-2]
    step = max(1, piece // (t.numel() // R))
    return [(Ellipsis, slice(i, min(i + step, R)), slice(None)) for i in range(0, R, step)]


def _adafactor(lr, stacks, layouts=None, eps=1e-30, decay=0.8, clip=1.0):
    """Factored second moments for leaves of two or more axes (a stacked
    leaf counts its repeat axis, as the reference's does).

    Each statistic is the reference's over the whole leaf, taken in parts
    so that no float32 copy of a large leaf is ever whole. A part holds
    whole rows and columns of the leaf's last two axes: a stacked leaf's
    layers one at a time (a stacked leaf of 1-D layers, its layers being
    its rows, as one small stacked copy). Each part is read in blocks of
    at most PIECE elements of whole rows: the row means per block, the
    column sums added over the blocks; then the new ``vr`` and ``vc``, the
    update's sum of squares over the whole leaf (its RMS for the
    clipping), then the update itself, block by block. Under rules the row
    means, column sums, ``vr``'s means and the sum of squares are each
    reduced over the ranks once a leaf (:class:`LeafLayout`). The
    arithmetic is the reference's up to the order of the sums, and the
    state is its tree."""

    def init(params):
        def st(ts, stacked):
            ndim = ts[0].dim() + int(stacked)
            if ndim >= 2:
                return {"vr": _zeros_like_group(ts, stacked, lambda s: s[:-1]),
                        "vc": _zeros_like_group(ts, stacked, lambda s: s[:-2] + s[-1:])}
            return {"v": _zeros_like_group(ts, stacked)}

        return _state_tree(params, stacks, st)

    def parts(ps, gs, s, stacked):
        """(params, grads, state) of each part of the leaf."""
        if not stacked:
            return [(ps[0], gs[0], s)]
        if ps[0].dim() >= 2:
            return [(p, g, {k: v[r] for k, v in s.items()}) for r, (p, g) in
                    enumerate(zip(ps, gs))]
        return [(torch.stack(ps), torch.stack(gs), s)]

    def sq(g):
        gf = g.to(F32)
        return gf * gf + eps

    def update_of(g, st, idx, vr_mean):
        """The unclipped update of the block ``idx`` of a part."""
        gf = g[idx].to(F32)
        if "v" in st:
            return gf / (torch.sqrt(st["v"]) + eps)
        rr = st["vr"][idx[:-1]] / torch.clamp(vr_mean, min=eps)
        return gf / (torch.sqrt(rr)[..., None] * torch.sqrt(st["vc"])[..., None, :] + eps)

    def statistics(pts, lay, beta):
        """The new ``vr`` and ``vc`` of every part, written into its state."""
        row_means, col_sums = [], []
        for p, g, st in pts:
            rm, cs = torch.empty_like(st["vr"]), torch.zeros_like(st["vc"])
            for idx in _row_blocks(g, PIECE):
                g2 = sq(g[idx])
                rm[idx[:-1]] = torch.mean(g2, dim=-1)
                cs += torch.sum(g2, dim=-2)
            row_means.append(rm)
            col_sums.append(cs)
        row_means = lay.mean(row_means, -1)
        col_sums = lay.psum(col_sums, lay.axes(-2))
        rows = pts[0][1].shape[-2] * lay.size(lay.axes(-2))
        for (p, g, st), rm, cs in zip(pts, row_means, col_sums):
            st["vr"].copy_(beta * st["vr"] + (1 - beta) * rm)
            st["vc"].copy_(beta * st["vc"] + (1 - beta) * (cs / rows))

    def update(params, grads, state, step):
        beta = 1.0 - _stepf(step) ** (-decay)
        for path, ps, gs, stacked in _pairs(params, grads, stacks):
            lay = (layouts or {}).get(path, _LOCAL)
            stored = _get(state, path)
            s = {k: lay.state_in(k, t) for k, t in stored.items()}
            pts = parts(ps, gs, s, stacked)
            if "v" in s:
                for p, g, st in pts:
                    st["v"].copy_(beta * st["v"] + (1 - beta) * sq(g))
                means = [None] * len(pts)
            else:
                statistics(pts, lay, beta)
                means = lay.mean([torch.mean(st["vr"], dim=-1, keepdim=True)
                                  for _, _, st in pts], -2)
            # update clipping (RMS <= clip) over the whole leaf
            total = torch.zeros((), dtype=F32, device=ps[0].device)
            for (p, g, st), m in zip(pts, means):
                for idx in _row_blocks(g, PIECE):
                    total += torch.sum(torch.square(update_of(g, st, idx, m)))
            (total,) = lay.psum([total], lay.axes())
            n = sum(t.numel() for t in ps) * lay.size(lay.axes())
            div = torch.clamp(torch.sqrt(total / n + 1e-12) / clip, min=1.0)
            for (p, g, st), m in zip(pts, means):
                for idx in _row_blocks(g, PIECE):
                    u = update_of(g, st, idx, m) / div
                    p[idx].copy_((p[idx].to(F32) - lr * u).to(p.dtype))
            if stacked and ps[0].dim() < 2:  # the stacked copy's rows back into the layers
                for r, t in enumerate(ps):
                    t.copy_(pts[0][0][r])
            for k, t in s.items():
                lay.state_out(k, stored[k], t)
        return params, state

    return init, update


def _sgdm(lr, stacks, mom=0.9):
    def init(params):
        return _state_tree(params, stacks,
                           lambda ts, stacked: {"m": _zeros_like_group(ts, stacked)})

    def update(params, grads, state, step):
        for path, ps, gs, stacked in _pairs(params, grads, stacks):
            s = _get(state, path)
            for r, (p, g) in enumerate(zip(ps, gs)):
                m = s["m"][r] if stacked else s["m"]
                m2 = mom * m + g.to(F32)
                p.copy_((p.to(F32) - lr * m2).to(p.dtype))
                m.copy_(m2)
        return params, state

    return init, update


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def compress_grads_int8(grads, error_fb, stacks: Stacks,
                        layouts: Optional[Dict[Path, LeafLayout]] = None):
    """Quantise grads to int8 with one scale per (reference) leaf and error
    feedback. Returns (the quantised grads as floats, in a new tree shaped
    like ``grads``; the error feedback, updated in place). Under rules each
    rank quantises its block of the data-summed gradient (as the reference
    quantises the global one) by the leaf's scale, the maximum of |g + e|
    over every axis the leaf lies on (``layouts``); the error feedback lies
    as its parameter. The gradient crosses the ranks in float32 before
    this: the compression cuts no collective's payload."""
    out = {}
    for path, gs, stacked in leaf_groups(grads, stacks):
        e = _get(error_fb, path)
        gfs = [g.to(F32) + (e[r] if stacked else e) for r, g in enumerate(gs)]
        amax = (layouts or {}).get(path, _LOCAL).pmax(
            torch.stack([torch.max(torch.abs(gf)) for gf in gfs]).max())
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for r, (g, gf) in enumerate(zip(gs, gfs)):
            qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            deq = qi.to(F32) * scale
            out[id(g)] = deq.to(g.dtype)
            (e[r] if stacked else e).copy_(gf - deq)
    return tree_map(lambda g: out[id(g)], grads), error_fb


def init_error_fb(params, stacks: Stacks):
    return _state_tree(params, stacks, _zeros_like_group)
