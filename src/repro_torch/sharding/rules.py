"""Logical-axis -> mesh-axis sharding rules (counterpart of
``repro/sharding/rules.py``).

Every parameter, input and cache leaf carries a tuple of *logical* axis
names (``ModelDef.param_axes``, ``input_specs``, ``abstract_cache``).
``MeshRules`` maps logical names to mesh axes with the reference's checks:
a mesh axis is assigned only if the dim size is divisible by the mesh
axis's extent and the axis is not already used by another dim of the same
leaf. The result is a *spec*: a plain tuple with one entry a dim, each
entry ``None``, a mesh axis name or a tuple of axis names, so it compares
directly with ``tuple(jax.sharding.PartitionSpec)``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or a :class:`MeshShape` (names and sizes, no devices) for meshes that exist
on no single host, such as the production meshes of 256 and 512 ranks.
``placements_for`` turns a spec into DTensor placements, and
``distribute_tree`` lays a tree of tensors over a DeviceMesh with them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

Axes = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axes, ...]

# Default logical -> candidate mesh axes. Each entry is a priority list;
# the first candidate that (a) divides the dim and (b) uses only unused
# mesh axes wins. "__data__" expands to all data-parallel axes present in
# the mesh (("pod","data") or ("data",)).
DEFAULT_RULES: Dict[str, Sequence[Axes]] = {
    "batch": ["__data__"],
    "seq": [None],
    # kv tensors keep their sequence dim replicated even under the
    # sequence-parallel overrides
    "kv_seq": [None],
    "embed": [None],
    "vocab": ["model"],
    "heads": ["model"],
    "kv_heads": ["model"],
    # no "head_dim" fallback: sharding the contraction dim of attention
    # would split the score tensor's sums across ranks
    "head_dim": [None],
    "mlp": ["model"],
    "expert": ["model"],
    "expert_mlp": [None],
    "lru": ["model"],
    "conv": [None],
    "layers": [None],
    "stack": [None],
    "capacity": ["__data__"],  # MoE dispatch buffers
    "img": [None],
    "frames": [None],
}

FSDP_RULES: Dict[str, Sequence[Axes]] = {
    # With FSDP on, any still-unsharded big dim picks up the data axes.
    "embed": ["__data__"],
    "mlp": ["__data__"],
    "expert_mlp": ["__data__"],
    "vocab_fsdp": ["__data__"],
}

DATA_AXES = ("pod", "data")


@dataclass(frozen=True)
class MeshShape:
    """A mesh as names and sizes, without devices: what the rules need of
    a mesh that exists on no single host (``launch.mesh.make_production_mesh``).
    ``shape`` maps each name to its size, as a jax ``Mesh.shape`` does."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh with named dims, or
    of any object with ``axis_names`` and a ``shape`` mapping (a
    :class:`MeshShape`, the reference tests' FakeMesh)."""
    if hasattr(mesh, "mesh_dim_names"):  # a DeviceMesh: shape is a tuple of sizes
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh for MeshRules needs named dims (mesh_dim_names)")
        return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def entry_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_spec(x) -> bool:
    """An axes tuple or a spec: a tuple of None, names and tuples of names.
    (Trees in the port hold dicts and lists, never tuples, so a tuple is a
    leaf.)"""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def map_specs(fn, spec_tree, *trees):
    """``fn(leaf spec, *leaves)`` over a tree of axes tuples or specs and
    trees of the same structure (dicts and lists)."""
    if is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees)) for k in spec_tree}
    if isinstance(spec_tree, list):
        return [map_specs(fn, s, *ts) for s, *ts in zip(spec_tree, *trees)]
    raise TypeError(f"not an axes tree node: {type(spec_tree).__name__}")


@dataclass
class MeshRules:
    mesh: Any
    fsdp: bool = False
    overrides: Dict[str, Sequence[Axes]] = field(default_factory=dict)

    def __post_init__(self):
        self.axes = mesh_axes(self.mesh)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in DATA_AXES)

    def _expand(self, cand: Axes) -> Optional[Tuple[str, ...]]:
        if cand is None:
            return None
        if cand == "__data__":
            return self.data_axes
        if isinstance(cand, str):
            return (cand,)
        out = []
        for c in cand:
            out.extend(self.data_axes if c == "__data__" else [c])
        return tuple(out)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.axes[a] for a in entry_axes(axes))

    def spec_for(self, logical: Tuple, shape: Tuple[int, ...]) -> Spec:
        """The spec of one leaf."""
        if len(logical) != len(shape):
            raise ValueError(f"logical axes {logical} for a shape of {len(shape)} dims {shape}")
        used: set = set()
        # pass 1: primary rules
        entries = [self._assign(name, dim, used, DEFAULT_RULES)
                   for name, dim in zip(logical, shape)]
        # pass 2: FSDP picks up remaining big dims
        if self.fsdp:
            for i, (name, dim) in enumerate(zip(logical, shape)):
                if entries[i] is None:
                    entries[i] = self._assign(name, dim, used, FSDP_RULES)
        return tuple(entries)

    def _assign(self, name, dim, used, table) -> Axes:
        if name is None:
            return None
        rules = self.overrides.get(name, table.get(name))
        if not rules:
            return None
        for cand in rules:
            axes = self._expand(cand)
            if axes is None:
                return None
            if any(a in used for a in axes):
                continue
            if any(a not in self.axes for a in axes):
                continue
            if dim % self.axis_size(axes) != 0:
                continue
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
        return None

    def placements(self, spec: Spec) -> tuple:
        """DTensor placements of a spec, one per mesh dim: ``Shard(i)`` on
        every mesh dim that tensor dim i uses, ``Replicate()`` elsewhere. A
        dim over several mesh dims is split over them in mesh order, the
        first the major (DTensor's order, and jax's for an entry in mesh
        order); an entry out of mesh order raises."""
        names = list(self.axes)
        out = [Replicate()] * len(names)
        for i, entry in enumerate(spec):
            dims = [names.index(a) for a in entry_axes(entry)]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} is not in mesh order {tuple(names)}")
            for m in dims:
                out[m] = Shard(i)
        return tuple(out)

    def placements_for(self, logical: Tuple, shape: Tuple[int, ...]) -> tuple:
        return self.placements(self.spec_for(logical, shape))

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis of the DeviceMesh."""
        return dict(zip(self.axes, self.mesh.get_coordinate()))

    def local_shard(self, x: torch.Tensor, spec: Spec,
                    coord: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """The block of the global tensor ``x`` under ``spec`` (a view) of the
        rank at ``coord`` (default: this rank): a dim over several axes is
        cut into their product of blocks, the first axis the major, as
        ``placements`` lays it out."""
        coord = self.coordinate() if coord is None else coord
        for i, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes:
                continue
            idx = 0
            for a in axes:
                idx = idx * self.axes[a] + coord[a]
            size = x.shape[i] // self.axis_size(axes)
            x = x.narrow(i, idx * size, size)
        return x


def logical_to_spec(rules: MeshRules, axes_tree, shape_tree):
    """(axes tree, tree of tensors or objects with ``.shape``) -> tree of specs."""
    return map_specs(lambda ax, leaf: rules.spec_for(tuple(ax), tuple(leaf.shape)),
                     axes_tree, shape_tree)


def shard_tree(rules: MeshRules, axes_tree, shape_tree):
    """(axes tree, tree of tensors) -> tree of DTensor placements."""
    return map_specs(lambda ax, leaf: rules.placements_for(tuple(ax), tuple(leaf.shape)),
                     axes_tree, shape_tree)


def distribute_tree(rules: MeshRules, axes_tree, values):
    """Each tensor of ``values`` laid over the rules' DeviceMesh as its spec
    says (``distribute_tensor``; every rank passes the same global values):
    a tree of DTensors, whose ``to_local()`` is this rank's shard."""
    return map_specs(
        lambda ax, t: distribute_tensor(t, rules.mesh, rules.placements_for(tuple(ax),
                                                                          tuple(t.shape))),
        axes_tree, values)


def constrain(x: torch.Tensor, rules: Optional[MeshRules], logical: Tuple) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes; a no-op
    when ``rules`` is None. In the reference it is a layout hint to XLA's
    partitioner that never changes a value, and the port runs each rank on
    its local tensors, so it returns ``x`` itself. With rules it checks that
    ``x`` is a local tensor the port runs: one logical axis a dim, and a
    "batch" dim that is this rank's share of a global batch which the spec
    lays over exactly the data axes (the residual stream is split over the
    data axes only: the "model" axis splits the work inside each block,
    :mod:`repro_torch.sharding.tp`, and sequence parallelism is not ported,
    ROADMAP.md Queue 1, item 9.8)."""
    if rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"constrain: logical axes {logical} for a tensor of shape "
                         f"{tuple(x.shape)}")
    n_data = rules.axis_size(rules.data_axes)
    glob = tuple(n * n_data if name == "batch" else n for name, n in zip(logical, x.shape))
    for name, entry in zip(logical, rules.spec_for(tuple(logical), glob)):
        if name == "batch" and entry_axes(entry) != rules.data_axes:
            raise ValueError(f"constrain: the batch dim of {tuple(x.shape)} lies on {entry}, "
                             f"not on the data axes {rules.data_axes}")
    return x
