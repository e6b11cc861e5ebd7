"""Multi-pod dry run on fake tensors: one (arch x shape x mesh x variant)
cell's memory, FLOPs, bytes and collectives per device, and its roofline
on the H100 (counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh multi --out experiments/dryrun_torch/....json

The reference lowers and compiles the step for a 256- or 512-device host
mesh and reads XLA's memory and cost analyses. The port has no compiled
module; it runs the step itself, eagerly, as rank 0 of the production mesh,
on fake tensors (``torch._subclasses.FakeTensorMode``: shapes and dtypes,
no storage; labelled ``FAKE_DEVICE``) over a ``fake`` process group of 256 or 512 ranks. Nothing is
allocated on any device, and no card is needed: the process hides any card
it has (``CUDA_VISIBLE_DEVICES`` empty). The mesh is a ``DeviceMesh("cuda",
...)`` of ``launch.mesh.make_production_mesh``'s shape, the rules are
``MeshRules`` over it, and rank 0 holds its shards of the abstract train
state, parameters and cache (``train.step.abstract_state`` /
``ModelDef.abstract_init`` / ``abstract_cache``, cut as ``run_specs``,
``state_shardings``, ``batch_shardings`` and ``cache_shardings`` lay them
out). One train step, prefill or decode step then runs on them under the
FLOP / byte / collective counter (``roofline/counter.py``) and
``torch.distributed._tools.mem_tracker.MemTracker``. The kernels take
their shape-only path (``kernels/fake.py``): no plain version runs and no
kernel is launched.

The JSON keys are the reference's, with these readings of an eager step:
- ``memory.argument_bytes``: the step's inputs on this rank (its shards of
  the state or parameters and cache, and its batch);
- ``output_bytes``: its outputs (the new state, or the logits and caches);
- ``alias_bytes``: the outputs that are inputs updated in place (the train
  state, a decode step's cache tensors);
- ``peak_per_device``: MemTracker's peak over the step, the inputs made
  inside it; ``temp_bytes`` is what the reference's identity ``peak =
  argument + output + temp - alias`` leaves for it;
- ``cost``: the counter's FLOPs and bytes (eager and unfused bytes: see
  ``roofline/counter.py``);
- ``trace_s`` stands where the reference has ``lower_s`` and ``compile_s``.
  Its ``cost_analysis_*_body_once`` keys (XLA's count of a loop body once)
  have no counterpart: the eager step runs every layer.
The ``flash`` variants report their base variant's numbers: the port's
attention, wkv6 and RG-LRU are fused kernels whose own traffic the counter
takes, so no score tensor is left to remove (``flash_adjust`` says so).
A variant or arch the port cannot run gives ``{"error": ...}`` with the
``NotImplementedError``'s text, as the reference's ``dryrun_all`` records a
failed cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, all_archs, applicable, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.roofline.analysis import H100_SXM, model_flops, param_count, roofline_terms
from repro_torch.roofline.counter import StepCounter
from repro_torch.sharding.rules import MeshRules, map_specs
from repro_torch.train.step import (abstract_state, batch_shardings, cache_shardings,
                                    make_decode_step, make_prefill_step, make_train_step,
                                    shard_state)
from repro_torch.utils.tree import flatten, tree_bytes, unflatten

# Variants: named config / sharding tweaks (the reference's table).
# "baseline" is the paper-faithful default configuration.
VARIANTS = {
    "baseline": {},
    "fsdp": {"fsdp": True},
    "no_fsdp": {"fsdp": False},
    "compress": {"grad_compression": True},
    "sp_model": {"overrides": {"seq": ["model"]}},  # sequence/context parallel
    "sp_flash": {"overrides": {"seq": ["model"]}, "flash_adjust": True},
    "flash": {"flash_adjust": True},
    "moe_manual": {"moe_impl": "manual"},  # expert parallelism over "model"
    "moe_manual_flash": {"moe_impl": "manual", "flash_adjust": True},
    "moe_manual_compress": {"moe_impl": "manual", "grad_compression": True},
    "sp_moe_manual": {"overrides": {"seq": ["model"]}, "moe_impl": "manual"},
    "sp_moe_manual_flash": {
        "overrides": {"seq": ["model"]},
        "moe_impl": "manual",
        "flash_adjust": True,
    },
    "seq_shard": {"overrides": {"seq": ["__data__"]}},
    "cache_seq_shard": {"overrides": {"seq": ["__data__"]}},
    "kv_int8": {"kv_cache_dtype": "int8"},
    "serve_bf16_kv8": {"kv_cache_dtype": "int8", "param_dtype": "bfloat16"},
}

#: the fake tensors' device label. Autograd's gradient accumulators ask for
#: the device's guard, which a CPU-only build of torch has for "cpu" only;
#: a fake tensor's shapes, bytes and FLOPs do not depend on the label
FAKE_DEVICE = "cpu"

FLASH_NOTE = ("the port's attention, wkv6 and rglru are fused kernels whose own traffic the "
              "counter takes (kernels/fake.py): no score tensor is held, so there is nothing to "
              "remove and the numbers are the base variant's")


def fake_mesh(shape):
    """A ``DeviceMesh("cuda", ...)`` of ``shape`` (a ``MeshShape``) over a
    ``fake`` process group of its size with this process as rank 0. The
    flattened group of every two or more of its axes (the data axes; all
    the axes a leaf lies on, for the optimizers' whole-leaf statistics) is
    made here, before any fake tensor mode: DeviceMesh builds it from real
    tensors."""
    from itertools import combinations

    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape.sizes)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    mesh = DeviceMesh("cuda", torch.arange(n).view(*shape.sizes),
                      mesh_dim_names=shape.axis_names)
    for k in range(2, len(shape.axis_names) + 1):
        for axes in combinations(shape.axis_names, k):
            mesh[axes]._flatten()
    return mesh


def _placed(rules, t, placements):
    """The local shape of the global tensor ``t`` under DTensor
    ``placements`` (one a mesh dim, in the rules' mesh order)."""
    shape = list(t.shape)
    for n, p in zip(rules.axes.values(), placements):
        if p.is_shard():
            shape[p.dim] //= n
    return tuple(shape)


def _fresh(tree, device):
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [torch.empty(t.shape, dtype=t.dtype, device=device)
                               for t in leaves])


def _bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _step(model, rules, shape, grad_compression: bool, device):
    """(run, state_bytes_global) of one step of ``shape`` on this rank's
    shards: ``run()`` makes the inputs as fresh tensors (inside the fake mode
    and the trackers, so that the peak holds them), runs the step and
    returns (the input leaves, the output leaves)."""
    B, S = shape.global_batch, shape.seq_len
    values, _ = model.input_specs(shape)
    # this rank's shard of each input: the tokens int32, an encoder-decoder's
    # frames and a vision config's image embeddings too
    inputs = {name: (_placed(rules, t, sh), t.dtype) for (name, t), sh in zip(
        values.items(), batch_shardings(model, rules, shape).values())}

    def fresh_batch():
        return {name: torch.empty(shp, dtype=dt, device=device)
                for name, (shp, dt) in inputs.items()}

    if shape.kind == "train":
        abstract = abstract_state(model, grad_compression)
        train_step, _ = make_train_step(model, rules, grad_compression=grad_compression)
        local_state = shard_state(model, rules, abstract)

        def run():
            state = _fresh(local_state, device)
            batch = fresh_batch()
            ins = flatten(state)[0] + list(batch.values())
            new, metrics = train_step(state, batch)
            return ins, flatten((new, metrics))[0]

        return run, tree_bytes(abstract)
    params_meta = model.abstract_init()
    specs = model.run_specs(rules)
    local_params = map_specs(lambda spec, t: rules.local_shard(t, spec), specs, params_meta)
    if shape.kind == "prefill":
        prefill_step = make_prefill_step(model, rules)

        def run():
            params = _fresh(local_params, device)
            batch = fresh_batch()
            with torch.no_grad():
                out = prefill_step(params, batch)
            return flatten(params)[0] + list(batch.values()), flatten(out)[0]

        return run, tree_bytes(params_meta)
    decode_step = make_decode_step(model, rules)
    cache_sh, cache_meta = cache_shardings(model, rules, B, S)
    local_cache = [{k: torch.empty(_placed(rules, t, sh[k]), dtype=t.dtype, device="meta")
                    for k, t in layer.items()} for layer, sh in zip(cache_meta, cache_sh)]

    def run():
        params = _fresh(local_params, device)
        cache = _fresh(local_cache, device)
        tokens = torch.empty(inputs["tokens"][0], dtype=torch.int64, device=device)
        ins = flatten(params)[0] + flatten(cache)[0] + [tokens]
        with torch.no_grad():
            out = decode_step(params, tokens, S - 1, cache)
        return ins, flatten(out)[0]

    return run, tree_bytes(params_meta) + tree_bytes(cache_meta)


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline"):
    """One cell's record (the reference's keys; see the module docstring)."""
    shape = SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant}
    try:
        if arch not in all_archs():
            raise NotImplementedError(
                f"{arch} is not ported yet: the port runs {sorted(all_archs())} (ROADMAP.md "
                f"Queue 1, item 9.7)")
        return _run_cell(result, get_arch(arch), shape, mesh_kind, variant)
    except NotImplementedError as e:
        return {**result, "error": str(e)}


def _run_cell(result, cfg, shape, mesh_kind: str, variant: str):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    ok, why = applicable(cfg, shape)
    counts = param_count(cfg)
    result.update(params_total=counts["total"], params_active=counts["active"])
    if not ok:
        result["skipped"] = why
        return result
    v = dict(VARIANTS[variant])
    overrides = v.pop("overrides", {})
    grad_compression = v.pop("grad_compression", False)
    flash_adjust = v.pop("flash_adjust", False)
    if v:
        cfg = dataclasses.replace(cfg, **v)
    model = build_model(cfg)
    mshape = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = math.prod(mshape.sizes)
    rules = MeshRules(fake_mesh(mshape), fsdp=cfg.fsdp, overrides=overrides)

    t0 = time.perf_counter()
    run, result["state_bytes_global"] = _step(model, rules, shape, grad_compression,
                                              FAKE_DEVICE)
    with FakeTensorMode():
        tracker = MemTracker()
        with tracker, StepCounter() as counter:
            ins, outs = run()
        peak = tracker.get_tracker_snapshot("peak")
    result["trace_s"] = time.perf_counter() - t0

    in_ids = {id(t) for t in ins}
    alias = _bytes(t for t in outs if id(t) in in_ids)
    mem = {"argument_bytes": _bytes(ins), "output_bytes": _bytes(outs), "alias_bytes": alias,
           "peak_per_device": sum(snap["Total"] for snap in peak.values())}
    mem["temp_bytes"] = (mem["peak_per_device"] - mem["argument_bytes"] - mem["output_bytes"]
                         + alias)
    mem["fits_hbm"] = bool(mem["peak_per_device"] <= H100_SXM.hbm_bytes)
    result["memory"] = mem
    stats = counter.stats()
    colls = stats["collectives"]
    flops_dev, bytes_dev = float(stats["flops"]), float(stats["bytes"])
    result["cost"] = {"flops_per_device": flops_dev, "bytes_per_device": bytes_dev}
    result["kernels"] = stats["kernels"]
    result["collectives"] = {k: c for k, c in colls.items() if c["count"] > 0 or k == "_total"}
    mf = model_flops(cfg, shape)
    result["model_flops_global"] = mf
    result["useful_compute_ratio"] = mf / (flops_dev * chips) if flops_dev else 0.0
    result["roofline"] = roofline_terms(flops_dev, bytes_dev, colls["_total"]["wire_bytes"],
                                        H100_SXM)
    if flash_adjust:
        result["flash_adjust"] = FLASH_NOTE
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # fake tensors only: no card is touched
    res = run_cell(args.arch, args.shape, args.mesh, args.variant)
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
