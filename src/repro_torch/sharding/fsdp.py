"""FSDP of the parameter leaves: each leaf gathered over the data axes just
in time.

With ``MeshRules(..., fsdp=True)`` the rules' second pass lays the dims
that the first left whole ("embed", "mlp", "expert_mlp", "vocab_fsdp")
over the data axes (``sharding/rules.py``), and each rank holds its block
of them. The reference leaves the gathering to XLA's partitioner. The port
gathers a block's leaves at its entry (:func:`gather`): every dim that lies
on the data axes is all-gathered over them, which gives exactly the layout
of the same rules without FSDP, so the "model"-axis code
(:mod:`repro_torch.sharding.tp`) runs unchanged after it. The gather's
backward reduce-scatters the leaf's gradient over the data axes: that is
the data-axis sum of the gradient, which ``train.step`` therefore does not
take again for such a leaf. Inside a block's remat region the recompute
gathers again, so no gathered leaf outlives its block.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import MeshRules, Spec, entry_axes, map_specs


def data_dims(spec: Spec, data_axes: Tuple[str, ...]) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, its axes) of each dim of ``spec`` that lies on data axes. A dim
    over the data axes and others at once has no gather that gives the
    layout without FSDP, and raises."""
    out = []
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        on_data = [a in data_axes for a in axes]
        if any(on_data) and not all(on_data):
            raise ValueError(f"fsdp: dim {i} of spec {spec} lies on data and other axes at once")
        if axes and all(on_data):
            out.append((i, axes))
    return out


def on_data(spec: Spec, rules: MeshRules) -> bool:
    """Whether the leaf of ``spec`` lies over any data axis."""
    return bool(data_dims(spec, rules.data_axes))


def gather_leaf(t: torch.Tensor, spec: Spec, rules: MeshRules) -> torch.Tensor:
    """``t`` (this rank's block under ``spec``) with every dim that lies on
    data axes gathered over them (``collectives.all_gather``)."""
    for dim, axes in data_dims(spec, rules.data_axes):
        t = C.all_gather(t, rules.mesh, axes, dim)
    return t


def gather(tree, specs, rules: MeshRules):
    """A tree of leaves (dicts and lists, as the parameters) with each leaf
    gathered as :func:`gather_leaf` does, by the tree of their ``specs``."""
    return map_specs(lambda spec, t: gather_leaf(t, spec, rules), specs, tree)
