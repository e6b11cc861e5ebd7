"""The "model"-axis split of a block (tensor parallelism) on this rank's
shards.

Under ``MeshRules`` every leaf lies as the rules say: "heads", "kv_heads",
"mlp", "lru", "vocab" and "expert" dims on the mesh's "model" axis where
they divide it, whole where they do not. The reference gets the
computation on those shards from XLA's partitioner. The port's kernels are
ctypes calls that DTensor cannot dispatch, so each block splits its own
work around them, with the two collectives of a column / row split:

- :func:`vary` where a value that every "model" rank holds alike (the
  block's input, a whole leaf) enters work that each rank does a part of:
  the identity forward, whose backward sums the ranks' parts of its
  gradient (``collectives.pvary``);
- :func:`psum` where the ranks' parts of an output are summed.

A block whose split dim is whole on this rank (no "model" axis, an axis of
1, or a dim that does not divide it) gets ``None`` from :func:`split` and
runs as it does without rules, with no collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.sharding import collectives as C


@dataclass(frozen=True)
class Split:
    """A dim split over "model": the mesh and this rank's block along it."""

    mesh: Any
    index: int


def split(rules, local: int, full: int) -> Optional[Split]:
    """The split of a dim of which this rank holds ``local`` of ``full``
    entries: None when it holds all of them."""
    if local == full:
        return None
    n = rules.axes.get("model", 1) if rules is not None else 1
    if local * n != full:
        raise ValueError(f"a dim of {full} held as {local} on a 'model' axis of {n}")
    return Split(rules.mesh, C.axis_index(rules.mesh, "model"))


def offset(s: Optional[Split], local: int) -> int:
    """The first global index of this rank's block of ``local`` entries."""
    return 0 if s is None else s.index * local


def vary(s: Optional[Split], x: torch.Tensor) -> torch.Tensor:
    return x if s is None else C.pvary(x, s.mesh, "model")


def psum(s: Optional[Split], x: torch.Tensor) -> torch.Tensor:
    return x if s is None else C.psum(x, s.mesh, "model")
