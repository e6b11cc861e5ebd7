"""Runs the port's sharding on gloo meshes of CPU processes, for the tests
``test_torch_sharding.py``, ``test_torch_moe_manual.py``,
``test_torch_pipeline.py`` and ``test_torch_tp.py``.

``run(fn, n, tmp_path, *args)`` spawns n processes, each joining a gloo
process group through a FileStore under ``tmp_path`` (no TCP port: the
tests run under pytest-xdist), calls ``fn(rank, *args)`` and saves what it
returns; the parent gets the n results in rank order. The workers below
take numpy inputs and import neither jax nor the JAX package; the tests
compute the reference's side in the parent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

THREADS = 2  # torch intra-op threads in every worker, as in the parent


def _entry(rank: int, n: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=n)
    try:
        torch.save(fn(rank, *args), f"{tmp}/rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, n: int, tmp_path, *args) -> list:
    mp.spawn(_entry, args=(n, str(tmp_path), fn, args), nprocs=n, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


def _tree(a, dtype=torch.float32):
    if isinstance(a, dict):
        return {k: _tree(v, dtype) for k, v in a.items()}
    return torch.tensor(np.asarray(a), dtype=dtype)


def items(tree, prefix: str = "") -> list:
    """[("a/b", leaf)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(items(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


# ---------------------------------------------------------------------------
# moe_apply_manual
# ---------------------------------------------------------------------------


def moe_cases(rank: int, cases):
    """Each case {name, n_data, n_model, change (to olmoe's reduced config:
    moe_impl and the layer's), overrides, p (numpy, the global layer), x, w
    (B, S, d)} on a mesh of this world: the layer on this rank's shards of
    p (whole on the auto path), x and w.
    Returns per case y, aux, the gradient of sum(y w) + aux with respect to
    the rank's x and every leaf (a leaf's summed over the data axes unless
    it is split over them, as ``train.step`` reduces it) and the rank's
    coordinate."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import MeshRules, entry_axes, map_specs

    out = {}
    for c in cases:
        cfg = dataclasses.replace(get_arch("olmoe-1b-7b").reduced(), **c["change"])
        rules = MeshRules(make_host_mesh(c["n_data"], c["n_model"], "cpu"), fsdp=cfg.fsdp,
                          overrides=c["overrides"])
        assert M.uses_manual(cfg, rules) == (cfg.moe_impl == "manual")
        specs = (M.manual_specs(cfg, rules) if cfg.moe_impl == "manual" else
                 map_specs(lambda ax: (None,) * len(ax), M.moe_axes(cfg)))
        xspec = ("data", "model" if c["overrides"] else None, None)
        tp = map_specs(lambda s, t: rules.local_shard(t, s).clone().requires_grad_(), specs,
                       _tree(c["p"]))
        tx = rules.local_shard(torch.tensor(c["x"]), xspec).clone().requires_grad_()
        tw = rules.local_shard(torch.tensor(c["w"]), xspec)
        y, aux = M.moe_apply(tp, tx, cfg, rules)
        names, leaves = zip(*items(tp))
        dx, *grads = torch.autograd.grad(torch.sum(y * tw) + aux, [tx, *leaves])
        for i, (_, spec) in enumerate(items(specs)):
            if not any(a in rules.data_axes for e in spec for a in entry_axes(e)):
                grads[i] = C.psum(grads[i], rules.mesh, rules.data_axes)
        out[c["name"]] = {"y": y.detach(), "aux": float(aux), "dx": dx,
                          "grads": dict(zip(names, grads)), "coord": rules.coordinate()}
    return out


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


def tanh_layer(lp, x):
    """tests/test_pipeline.py's layer."""
    return torch.tanh(x @ lp["w"] + lp["b"])


def pipeline_cases(rank: int, cases, params, x, n_micro: int):
    """``pipeline_apply`` of ``tanh_layer`` over each (n_data, n_model) mesh
    of this world: {(n_data, n_model): the output this rank gets}."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.pipeline import pipeline_apply

    tp, tx = _tree(params), torch.tensor(x)
    return {shape: pipeline_apply(tanh_layer, tp, tx, make_host_mesh(*shape, "cpu"), n_micro)
            for shape in cases}


# ---------------------------------------------------------------------------
# placements and the train step under rules
# ---------------------------------------------------------------------------


def olmoe_manual():
    """olmoe-1b-7b reduced, on the expert-parallel path (the port's config)."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("olmoe-1b-7b").reduced(), moe_impl="manual")


def distribute_cases(rank: int, values, fsdp_cases):
    """``distribute_tree`` of olmoe's reduced parameters (``values``: the
    reference's numpy values tree) over a (2, 2) mesh, with each ``fsdp``:
    {fsdp: {leaf path: (this rank's shard, full_tensor() equal to the
    input)}}, and the rank's coordinate."""
    from repro_torch import convert
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import MeshRules, distribute_tree
    from repro_torch.train.optim import _paths

    cfg = olmoe_manual()
    params = convert.from_jax_values(values, cfg, param_dtype=torch.float32)
    mesh = make_host_mesh(2, 2, "cpu")
    whole = dict(_paths(params))
    out = {"coord": MeshRules(mesh).coordinate()}
    for fsdp in fsdp_cases:
        tree = distribute_tree(MeshRules(mesh, fsdp=fsdp), build_model(cfg).param_axes(), params)
        out[fsdp] = {"/".join(path): (t.to_local().clone(), torch.equal(t.full_tensor(),
                                                                        whole[path]))
                     for path, t in _paths(tree)}
    return out


def train_cases(rank: int, state, tokens, lr: float):
    """One AdamW step of olmoe's reduced manual config from the reference's
    train state (numpy) on a (1, 2) and on a (2, 1) mesh, each rank on its
    data shard of ``tokens[0]``; then host 1 is lost: the (2, 1) job shrinks
    through ``replan``, ``reshard_batch`` and ``remesh_rules(1, 1)``, and the
    survivor takes the next step on the whole of ``tokens[1]``. Returns
    {case: {"loss", "state" (this rank's parameters and moments, by
    reference path), "coord"}}."""
    from repro_torch import convert
    from repro_torch.core.elastic import remesh_rules, replan, reshard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model_api import _stacks_for
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train.optim import _paths, leaf_groups
    from repro_torch.train.step import make_train_step, shard_state

    cfg = olmoe_manual()
    model = build_model(cfg)

    def ref_layout(st):
        """The parameters and AdamW moments by reference path ("a/b/m")."""
        out = {"/".join(path): torch.stack(ts_) if stacked else ts_[0].clone()
               for path, ts_, stacked in leaf_groups(st["params"], _stacks_for(cfg))}
        out.update({"/".join(path): t.clone() for path, t in _paths(st["opt"])})
        return out

    def step(shape, tokens_, rules=None):
        rules = rules or MeshRules(make_host_mesh(*shape, "cpu"))
        st = shard_state(model, rules, convert.train_state_from_jax(state, cfg))
        ts, _ = make_train_step(model, rules=rules, lr=lr)
        d = rules.coordinate()["data"]
        n = len(tokens_) // rules.axes["data"]
        new, m = ts(st, {"tokens": tokens_[d * n:(d + 1) * n]})
        return new, {"loss": float(m["loss"]), "coord": rules.coordinate(),
                     "state": ref_layout(new)}

    out = {"1x2": step((1, 2), tokens[0])[1]}
    state_2x1, out["2x1"] = step((2, 1), tokens[0])
    # host 1 is lost for good: no spare, so the job re-meshes on the survivor
    plan = replan(n_shards=2, alive_hosts=[0])
    parts = reshard_batch(len(tokens[1]), 1)
    dist.destroy_process_group()
    if rank == 0:
        assert plan.assignment == {0: [0, 1]} and parts == [len(tokens[1])]
        rules = remesh_rules(1, 1, device_type="cpu")
        ts, _ = make_train_step(model, rules=rules, lr=lr)
        new, m = ts(shard_state(model, rules, state_2x1), {"tokens": tokens[1]})
        out["remesh"] = {"loss": float(m["loss"]), "coord": rules.coordinate(),
                         "state": ref_layout(new)}
    return out


# ---------------------------------------------------------------------------
# the "model"-axis split (tensor parallelism) of whole models under rules
# ---------------------------------------------------------------------------


def tp_cases(rank: int, meshes, cases, tokens, steps: int, lr: float, fsdp: bool = False):
    """Each case {name, arch, change, state (the reference's initial train
    state, numpy), feed (the reference's greedy tokens of the decode steps,
    (steps, B)), frames (an encoder-decoder's (B, F, d), else None), images
    (a vision config's image embeddings (B, P, d), else None), train
    (False: serving only, ``state`` holds its params), optionally steps
    ({label: (optimizer, grad_compression, the reference's initial state for
    them)}; default {"adamw": ("adamw", False, state)}) and lr (default
    ``lr``)} on each (n_data,
    n_model) mesh of ``meshes``, with the rules' ``fsdp``: this rank's
    shards as ``run_specs`` lays them out (``shard_state``), its data shard
    of ``tokens`` (B, S) (and of the frames and images) through ``prefill``
    (cache S + P + steps), ``steps`` decode steps fed ``feed`` at positions
    S + P + i, then, when training, ``loss`` and one train step from each
    of the case's states (the frames and images in their batch).
    Returns {(mesh, name): {"logits" [(rows, vocab)] (prefill, then each
    step), "loss", "params" (this rank's, by reference path, before any
    step when serving only), "coord", and for training "steps" {label:
    {"loss", "params", "opt" (the optimizer state's leaves by path), "efb"}}
    with the "adamw" step's loss and parameters also as "step_loss" and
    "params"}}."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model_api import _stacks_for
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train.optim import _paths, leaf_groups
    from repro_torch.train.step import make_train_step, shard_state

    def by_path(params, cfg):
        return {"/".join(path): torch.stack(ts_) if stacked else ts_[0].clone()
                for path, ts_, stacked in leaf_groups(params, _stacks_for(cfg))}

    out = {}
    for shape in meshes:
        rules = MeshRules(make_host_mesh(*shape, "cpu"), fsdp=fsdp)
        d = rules.coordinate()["data"]
        n = len(tokens) // rules.axes["data"]
        rows = slice(d * n, (d + 1) * n)
        for c in cases:
            cfg = dataclasses.replace(get_arch(c["arch"]).reduced(), **c["change"])
            model = build_model(cfg)
            train = c.get("train", True)
            params = convert.from_jax_values(c["state"]["params"], cfg,
                                             param_dtype=getattr(torch, cfg.param_dtype)
                                             if train else torch.float32)
            st = shard_state(model, rules, {"params": params,
                                            "step": torch.zeros((), dtype=torch.int32)})
            toks = torch.from_numpy(np.asarray(tokens[rows])).long()
            frames, images = (None if c.get(key) is None else
                              torch.from_numpy(np.asarray(c[key][rows]))
                              for key in ("frames", "images"))
            P = toks.shape[1] + (0 if images is None else images.shape[1])
            with torch.no_grad():
                lg, cache = model.prefill(st["params"], toks, rules, cache_len=P + steps,
                                          frames=frames, image_embeds=images)
                logits = [lg]
                for i in range(steps):
                    feed = torch.from_numpy(np.asarray(c["feed"][i][rows])).long()[:, None]
                    lg, cache = model.decode(st["params"], feed, P + i, cache, rules)
                    logits.append(lg)
            res = {"logits": logits, "coord": rules.coordinate()}
            out[(shape, c["name"])] = res
            if not train:
                res["params"] = by_path(st["params"], cfg)
                continue
            batch = {"tokens": toks}
            for key, t in (("frames", frames), ("image_embeds", images)):
                if t is not None:
                    batch[key] = t
            with torch.no_grad():
                res["loss"] = float(model.loss(st["params"], batch, rules))
            res["steps"] = {}
            for label, (opt, gc, state) in (c.get("steps") or
                                            {"adamw": ("adamw", False, c["state"])}).items():
                scfg = dataclasses.replace(cfg, optimizer=opt)
                smodel = build_model(scfg)
                sst = shard_state(smodel, rules, convert.train_state_from_jax(state, scfg))
                ts, _ = make_train_step(smodel, rules=rules, lr=c.get("lr", lr),
                                        grad_compression=gc)
                new, m = ts(sst, batch)
                res["steps"][label] = {
                    "loss": float(m["loss"]), "params": by_path(new["params"], scfg),
                    "opt": {"/".join(path): t.clone() for path, t in _paths(new["opt"])},
                    "efb": {"/".join(path): t.clone() for path, t in _paths(new.get("efb", {}))}}
            if "adamw" in res["steps"]:
                res["step_loss"] = res["steps"]["adamw"]["loss"]
                res["params"] = res["steps"]["adamw"]["params"]
    return out


def adafactor_piece_cases(rank: int, arch: str, shape, pieces, lr: float):
    """Two Adafactor updates of ``arch``'s reduced parameters (float32
    masters; seeded draws, the same on every rank) under FSDP rules on a
    ``shape`` mesh, each rank on its shards (``shard_state``), the
    statistics over the whole leaf (``train.step.leaf_layouts``), with
    ``optim.PIECE`` set to each of ``pieces``: {piece: (this rank's
    parameters, optimizer state) by path}."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model_api import _stacks_for
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train import optim
    from repro_torch.train.step import leaf_layouts, shard_state
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), param_dtype="float32",
                              optimizer="adafactor", fsdp=True)
    model = build_model(cfg)
    rules = MeshRules(make_host_mesh(*shape, "cpu"), fsdp=True)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu", param_dtype=torch.float32)
    grads = [tree_map(lambda t: torch.randn(t.shape, generator=gen), params) for _ in range(2)]
    out = {}
    for piece in pieces:
        optim.PIECE = piece
        init, update = optim.make_optimizer("adafactor", _stacks_for(cfg), lr=lr,
                                            layouts=leaf_layouts(model, rules))
        st = shard_state(model, rules, {"params": params, "opt": init(params),
                                        "step": torch.zeros((), dtype=torch.int32)})
        p, s = tree_map(lambda t: t.clone(), st["params"]), tree_map(lambda t: t.clone(),
                                                                       st["opt"])
        for step in range(2):  # the second step reads the statistics the first wrote
            g = shard_state(model, rules, {"params": grads[step]})["params"]
            p, s = update(p, g, s, torch.tensor(step, dtype=torch.int32))
        out[piece] = ({"/".join(k): v for k, v in optim._paths(p)},
                      {"/".join(k): v for k, v in optim._paths(s)})
    return out
