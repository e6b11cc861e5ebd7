"""Meshes (counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module creates no
process group. ``make_host_mesh`` builds a real ``DeviceMesh`` over the
ranks of the running job (on the card unless the caller asks for the CPU);
``make_production_mesh`` gives the shape of the 256- or 512-rank mesh that
exists on no single host, as a ``MeshShape`` for the rules.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.rules import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ``(n_data, n_model)`` DeviceMesh named ``("data", "model")`` over
    the job's ranks. With no process group and one rank asked for, it first
    creates a single-process group (NCCL on the card, gloo on the CPU);
    otherwise the job's group must hold exactly ``n_data * n_model`` ranks.
    Raises when CUDA is asked for and there is none: it never goes on on
    the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: device_type {device_type!r} (cuda or cpu)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: device_type='cuda' but torch.cuda.is_available() "
                           "is false (pass device_type='cpu' for a gloo mesh on the CPU)")
    n = n_data * n_model
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"make_host_mesh: a ({n_data}, {n_model}) mesh needs a process "
                               f"group of {n} ranks (torch.distributed.init_process_group)")
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_host_mesh: a ({n_data}, {n_model}) mesh over a process group "
                           f"of {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))
