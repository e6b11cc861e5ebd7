"""Collectives over named mesh axes: the counterparts of the ``jax.lax``
collectives that the reference's ``shard_map`` bodies call (``psum``,
``pmean``, ``all_gather(tiled=True)``, ``psum_scatter(tiled=True)``,
``ppermute``, ``axis_index``), on ``torch.distributed`` process groups.

Each takes the ``DeviceMesh`` and ``axes``: one axis name, or a tuple of
names taken together as one group (the data axes ``("pod", "data")``,
flattened with the first the major). An empty tuple is a group of one
rank: the collective is the identity.

Gradients follow what each collective means for a value that every rank
of the group goes on with alike:
- ``psum`` / ``pmean``: the output is the same on every rank, so its
  gradient is the identity (a second all-reduce would count each rank's
  cotangent ``n`` times);
- ``pmax``: the elementwise maximum over the ranks; its gradient reaches
  the elements that equal the maximum (on each rank that holds one);
- ``pvary``: the identity forward, whose backward sums over the axes
  (jax's ``pvary``): a value every rank holds alike that enters a
  computation each rank does a part of, so that each rank's cotangent is
  a part;
- ``all_gather`` <-> ``psum_scatter``: each is the other's backward;
- ``ppermute``: the inverse permutation.

Each collective reports its kind and operand bytes to the dry run's
counter when one is open (:mod:`repro_torch.roofline.counter`).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.roofline import counter
from repro_torch.sharding.rules import mesh_axes

AxisNames = Union[str, Tuple[str, ...]]


def _names(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: AxisNames) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _names(axes))


def axis_index(mesh, axes: AxisNames) -> int:
    """This rank's index along ``axes`` (flattened, the first the major)."""
    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    idx = 0
    for a in _names(axes):
        idx = idx * sizes[a] + coord[a]
    return idx


def group(mesh, axes: AxisNames):
    """The process group of ``axes`` (None for no axes)."""
    names = _names(axes)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def _run(kind: str, collective, out: torch.Tensor, *src: torch.Tensor) -> None:
    """``collective(out, *src)``, counted under ``kind`` (the reference's
    name) by the operand's bytes."""
    operand = src[0] if src else out
    counter.collective(kind, operand.numel() * operand.element_size())
    collective(out, *src)


def _all_reduce(x: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    if grp is not None:
        _run("all-reduce", lambda o: dist.all_reduce(o, op=op, group=grp), out)
    return out


def _gather(x: torch.Tensor, grp, n: int, dim: int) -> torch.Tensor:
    if grp is None:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    _run("all-gather", lambda o, s: dist.all_gather_into_tensor(o, s, group=grp), out, src)
    return _natural(out, dim)


def _natural(out: torch.Tensor, dim: int) -> torch.Tensor:
    """``out`` (the collective's result along its first dim) with that dim
    moved back to ``dim``, contiguous: a strided view would take other
    kernels downstream (a matrix product, a reduction) that round
    otherwise than on the tensor without the collective."""
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, grp, n: int, dim: int) -> torch.Tensor:
    if grp is None:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} is not a multiple of {n}")
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    _run("reduce-scatter", lambda o, s: dist.reduce_scatter_tensor(o, s, group=grp), out, src)
    return _natural(out, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        out = _all_reduce(x, grp, dist.ReduceOp.MAX)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out = ctx.saved_tensors
        return torch.where(x == out, dy, torch.zeros_like(dy)), None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.grp), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, n, dim):
        ctx.args = (grp, n, dim)
        return _gather(x, grp, n, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter(dy, *ctx.args), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, n, dim):
        ctx.args = (grp, n, dim)
        return _scatter(x, grp, n, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, *ctx.args), None, None, None


def psum(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, on every one of them."""
    return _PSum.apply(x, group(mesh, axes))


def pmean(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def pmax(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes``, on every
    one of them (jax's ``pmax``)."""
    return _PMax.apply(x, group(mesh, axes))


def pvary(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the ranks of ``axes``."""
    return _PVary.apply(x, group(mesh, axes))


def all_gather(x: torch.Tensor, mesh, axes: AxisNames, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (jax's
    ``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, group(mesh, axes), axis_size(mesh, axes), dim)


def psum_scatter(x: torch.Tensor, mesh, axes: AxisNames, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axes``, cut along ``dim`` into their
    number of blocks; rank i keeps block i (jax's ``psum_scatter(...,
    tiled=True)``)."""
    return _PSumScatter.apply(x, group(mesh, axes), axis_size(mesh, axes), dim)


def _permute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    grp, me = group(mesh, axis), axis_index(mesh, axis)
    out = torch.zeros_like(x)  # a rank that no pair sends to gets zeros, as in jax
    ops = []
    src = x.contiguous()
    for s, d in perm:
        if s == me and d == me:
            out = src.clone()
        elif s == me:
            counter.collective("collective-permute", src.numel() * src.element_size())
            ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(grp, d), grp))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(grp, s), grp))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, dy):
        return _permute(dy, *ctx.args), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Sends each rank's ``x`` along ``axis`` as the (source, destination)
    index pairs of ``perm`` say (jax's ``ppermute``): a pair of one rank
    with itself is a copy, point-to-point sends go through
    ``batch_isend_irecv`` inside the axis's group."""
    return _PPermute.apply(x, mesh, axis, list(perm))
