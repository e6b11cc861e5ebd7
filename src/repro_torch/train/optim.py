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
float32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_map

F32 = torch.float32
Path = Tuple[str, ...]
Stacks = Sequence[Tuple[Tuple[str, ...], int]]


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


def make_optimizer(kind: str, stacks: Stacks, lr: float = 1e-4, **kw):
    if kind == "adamw":
        return _adamw(lr, stacks, **kw)
    if kind == "adafactor":
        return _adafactor(lr, stacks, **kw)
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


def _adafactor(lr, stacks, eps=1e-30, decay=0.8, clip=1.0):
    """Factored second moments for leaves of two or more axes (a stacked
    leaf counts its repeat axis, as the reference's does)."""

    def init(params):
        def st(ts, stacked):
            ndim = ts[0].dim() + int(stacked)
            if ndim >= 2:
                return {"vr": _zeros_like_group(ts, stacked, lambda s: s[:-1]),
                        "vc": _zeros_like_group(ts, stacked, lambda s: s[:-2] + s[-1:])}
            return {"v": _zeros_like_group(ts, stacked)}

        return _state_tree(params, stacks, st)

    def update(params, grads, state, step):
        beta = 1.0 - _stepf(step) ** (-decay)
        for path, ps, gs, stacked in _pairs(params, grads, stacks):
            s = _get(state, path)
            gf = torch.stack([g.to(F32) for g in gs]) if stacked else gs[0].to(F32)
            g2 = gf * gf + eps
            if gf.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rr = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                u = gf / (torch.sqrt(rr)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
                new = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf / (torch.sqrt(v) + eps)
                new = {"v": v}
            # update clipping (RMS <= clip)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip, min=1.0)
            for r, p in enumerate(ps):
                p.copy_((p.to(F32) - lr * (u[r] if stacked else u)).to(p.dtype))
            for k, val in new.items():
                s[k].copy_(val)
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


def compress_grads_int8(grads, error_fb, stacks: Stacks):
    """Quantise grads to int8 with one scale per (reference) leaf and error
    feedback. Returns (the quantised grads as floats, in a new tree shaped
    like ``grads``; the error feedback, updated in place)."""
    out = {}
    for path, gs, stacked in leaf_groups(grads, stacks):
        e = _get(error_fb, path)
        gfs = [g.to(F32) + (e[r] if stacked else e) for r, g in enumerate(gs)]
        amax = torch.stack([torch.max(torch.abs(gf)) for gf in gfs]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for r, (g, gf) in enumerate(zip(gs, gfs)):
            qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            deq = qi.to(F32) * scale
            out[id(g)] = deq.to(g.dtype)
            (e[r] if stacked else e).copy_(gf - deq)
    return tree_map(lambda g: out[id(g)], grads), error_fb


def init_error_fb(params, stacks: Stacks):
    return _state_tree(params, stacks, _zeros_like_group)
