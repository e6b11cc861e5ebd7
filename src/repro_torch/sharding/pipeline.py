"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
``repro/sharding/pipeline.py``).

Layers are split into ``n_stages`` contiguous stages along the mesh's
"model" axis (each rank runs only its stage's layer slice); each data
shard's batch is split into microbatches that flow through the pipeline,
shifted one stage a tick by a ring ``ppermute`` inside the axis's group.
Tick count = n_micro + n_stages - 1 (fill + drain bubbles). The result is
numerically the layers applied in sequence (``tests/test_torch_pipeline.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import DATA_AXES, mesh_axes
from repro_torch.utils.tree import flatten, tree_map


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor, mesh, n_micro: int,
                   axis: str = "model") -> torch.Tensor:
    """Runs L = n_stages * layers_per_stage layers as a GPipe pipeline over
    the DeviceMesh axis ``axis``: ``layer_fn(layer_params, h)`` applied L
    times to ``x``. Every rank passes the global ``stacked_params`` (leaves
    (L, ...)) and the global ``x`` (B, ...) and gets the global output
    back, as the reference's ``shard_map`` with its specs gives it. A
    forward only (no gradient flows through it), as the reference's callers,
    its tests, use it."""
    sizes = mesh_axes(mesh)
    n_stages = sizes[axis]
    L = flatten(stacked_params)[0][0].shape[0]
    if L % n_stages:
        raise ValueError(f"pipeline_apply: {L} layers over {n_stages} stages")
    lps = L // n_stages
    data_axes = tuple(a for a in sizes if a in DATA_AXES)
    n_data = C.axis_size(mesh, data_axes)
    if x.shape[0] % (n_data * n_micro):
        raise ValueError(f"pipeline_apply: batch {x.shape[0]} over {n_data} data shards x "
                         f"{n_micro} microbatches")
    B_loc = x.shape[0] // n_data
    mb = B_loc // n_micro
    sid = C.axis_index(mesh, axis)
    d = C.axis_index(mesh, data_axes)
    params_stage = tree_map(lambda a: a[sid * lps:(sid + 1) * lps], stacked_params)
    layers = [tree_map(lambda a, i=i: a[i], params_stage) for i in range(lps)]
    micro = x[d * B_loc:(d + 1) * B_loc].reshape((n_micro, mb) + tuple(x.shape[1:]))
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    with torch.no_grad():
        out = torch.zeros_like(micro)
        buf = torch.zeros_like(micro[0])  # the activation entering this stage
        for t in range(n_micro + n_stages - 1):
            # stage s works on microbatch m = t - s when 0 <= m < n_micro
            m = t - sid
            h = buf
            if 0 <= m < n_micro:
                h = micro[min(t, n_micro - 1)] if sid == 0 else buf
                for lp in layers:
                    h = layer_fn(lp, h)
                if sid == n_stages - 1:  # the last stage writes its finished microbatch
                    out[m] = h
            buf = C.ppermute(h, mesh, axis, ring)
        # only the last stage's out is real: zero the others and sum
        out = C.psum(out * float(sid == n_stages - 1), mesh, axis)
        return C.all_gather(out.reshape((B_loc,) + tuple(x.shape[1:])), mesh, data_axes, dim=0)
