"""Step factories (counterpart of ``repro/train/step.py``): the train step
(loss, gradient, optimizer update), the prefill step and the decode step,
and the layouts of the train state, the batch and the cache over a mesh.

With ``rules`` the train step is the SPMD counterpart of the reference's
``jit`` with shardings: each rank runs ``ModelDef.loss`` on its data shard
of the batch (the global loss on every rank) and holds each parameter, and
its optimizer state, as ``state_specs`` says (``shard_state`` cuts a
global state so): the rules' layout, "model"-axis splits and FSDP's data
axes included. The steps run eagerly. ``abstract_state``, ``state_shardings``,
``batch_shardings`` and ``cache_shardings`` give the reference's layouts as
DTensor placements (:mod:`repro_torch.sharding.rules`), which the dry run
(``launch/dryrun.py``) reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.models.model_api import ModelDef, _stacks_for
from repro_torch.sharding import collectives as C
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import MeshRules, map_specs, shard_tree
from repro_torch.train.optim import (LeafLayout, _get, _paths, compress_grads_int8,
                                     init_error_fb, leaf_groups, make_optimizer)
from repro_torch.utils.tree import flatten, unflatten


def make_train_step(model: ModelDef, rules: Optional[MeshRules] = None, lr: float = 1e-4,
                    grad_compression: bool = False):
    """Returns (train_step, init_state).

    state = {"params": masters in ``cfg.param_dtype`` (float32, or kimi-k2's
    bfloat16, every floating leaf in it), "opt": optimizer state, "step":
    int32 tensor[, "efb": error feedback]}; ``train_step(state, batch)`` returns
    (new state, {"loss": loss}). The update is written into the state's
    tensors (see ``train.optim``): the returned state holds the same
    tensors, and a caller that must keep the old values copies them first.
    ``init_state(gen)`` draws the parameters from the torch Generator
    ``gen`` on its device, each leaf in its storage dtype at once (a large
    bfloat16 leaf is drawn in blocks: ``models.layers.DRAW_BLOCK``).

    With ``rules`` the state is this rank's (``shard_state``) and the batch
    its data shard. Each rank's gradient is its shard's part of the global
    loss's gradient; the parts of a leaf that every data rank holds whole
    are summed over the data axes. A leaf split over "model" is this rank's
    own and is not reduced there. A leaf whole over "model" that a rank
    uses only in part (rwkv6's ``wo``, ``wB`` and group-norm leaves, the kv
    projections that a rank's heads read, an MoE's gates) gets its sum over
    "model" where it is used: it passes ``sharding.tp.vary``, whose
    backward sums the ranks' parts. A leaf split over the data axes (FSDP)
    got its sum from the reduce-scatter in its gather's backward
    (``sharding/fsdp.py``). The update is then each rank's on its own
    shards; Adafactor's statistics and the int8 compression's scale are
    taken over the whole leaf (``train.optim.LeafLayout``)."""
    stacks = _stacks_for(model.cfg)
    layouts = None if rules is None else leaf_layouts(model, rules, grad_compression)
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, stacks, lr=lr, layouts=layouts)
    # per parameter leaf (in ``flatten`` order): whether its parts are summed
    # over the data axes
    data_sum = None if rules is None else [
        not fsdp.on_data(spec, rules) for _, spec in _paths(model.run_specs(rules))]
    model.fsdp_specs(rules)  # computed here, outside any step (see its docstring)

    def train_step(state, batch):
        leaves, treedef = flatten(state["params"])
        live = [p.detach().requires_grad_() for p in leaves]
        loss = model.loss(unflatten(treedef, live), batch, rules)
        grads = list(torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True))
        del live
        if rules is not None:
            grads = [C.psum(g, rules.mesh, rules.data_axes) if s else g
                     for g, s in zip(grads, data_sum)]
        grads = unflatten(treedef, grads)
        new_state = {}
        if grad_compression:
            grads, new_state["efb"] = compress_grads_int8(grads, state["efb"], stacks, layouts)
        new_state["params"], new_state["opt"] = opt_update(state["params"], grads, state["opt"],
                                                           state["step"])
        new_state["step"] = state["step"] + 1
        return new_state, {"loss": loss.detach()}

    def init_state(gen: torch.Generator):
        params = model.init(gen, gen.device, param_dtype=getattr(torch, model.cfg.param_dtype))
        st = {"params": params, "opt": opt_init(params),
              "step": torch.zeros((), dtype=torch.int32, device=gen.device)}
        if grad_compression:
            st["efb"] = init_error_fb(params, stacks)
        return st

    return train_step, init_state


def _ref_groups(model: ModelDef, tree):
    """{reference path: (the port's leaves of the group, stacked)}, in the
    optimizer state's (the reference's stacked) layout."""
    return {path: (ts, stacked)
            for path, ts, stacked in leaf_groups(tree, _stacks_for(model.cfg))}


def _set_path(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_specs(model: ModelDef, rules: MeshRules, grad_compression: bool = False):
    """The reference's layout of the train state as specs: the parameters
    as ``run_specs`` lays them out; each optimizer and error-feedback leaf
    as its parameter's reference leaf (a stacked leaf with its "layers"
    axis) where the shapes match, Adafactor's ``vr`` / ``vc`` by the axes
    left after their reduction over the last / second-to-last dim, anything
    else whole (the reference's ``state_shardings``)."""
    abstract = abstract_state(model, grad_compression)
    shapes = _ref_groups(model, abstract["params"])
    st = {"params": model.run_specs(rules), "opt": {}, "step": ()}
    if grad_compression:
        st["efb"] = {}
    for path, (group, stacked) in _ref_groups(model, model.param_axes()).items():
        ts = shapes[path][0]
        ax = (("layers",) + group[0]) if stacked else group[0]
        full = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)

        def like(leaf):
            shape = tuple(leaf.shape)
            if shape == full:
                return rules.spec_for(ax, shape)
            if shape == full[:-1]:  # vr
                return rules.spec_for(ax[:-1], shape)
            if shape == full[:-2] + full[-1:]:  # vc
                return rules.spec_for(ax[:-2] + ax[-1:], shape)
            return (None,) * len(shape)

        _set_path(st["opt"], path, {k: like(t) for k, t in _get(abstract["opt"], path).items()})
        if grad_compression:
            _set_path(st["efb"], path, rules.spec_for(ax, full))
    return st


def leaf_layouts(model: ModelDef, rules: MeshRules, grad_compression: bool = False):
    """{reference path: ``optim.LeafLayout``}: how each leaf of the
    optimizer's reference layout and its state lie over the mesh."""
    specs = state_specs(model, rules, grad_compression)
    return {path: LeafLayout(rules, ((None,) + group[0]) if stacked else group[0],
                             _get(specs["opt"], path))
            for path, (group, stacked) in _ref_groups(model, specs["params"]).items()}


def shard_state(model: ModelDef, rules: MeshRules, state):
    """This rank's part of a global train state (every rank passes the same
    one), as ``state_specs`` lays it out (views, not copies)."""
    specs = state_specs(model, rules, "efb" in state)
    return {key: map_specs(lambda spec, t: rules.local_shard(t, spec), specs[key], state[key])
            if key != "step" else state["step"] for key in state}


def abstract_state(model: ModelDef, grad_compression: bool = False):
    """The train state on the meta device (shapes and dtypes, no storage)."""
    stacks = _stacks_for(model.cfg)
    opt_init, _ = make_optimizer(model.cfg.optimizer, stacks)
    params = model.abstract_init()
    st = {"params": params, "opt": opt_init(params),
          "step": torch.empty((), dtype=torch.int32, device="meta")}
    if grad_compression:
        st["efb"] = init_error_fb(params, stacks)
    return st


def state_shardings(model: ModelDef, rules: MeshRules, grad_compression: bool = False):
    """``state_specs`` as DTensor placements."""
    return map_specs(rules.placements, state_specs(model, rules, grad_compression))


def batch_shardings(model: ModelDef, rules: MeshRules, shape: ShapeCfg):
    """The inputs of a step of ``shape`` as DTensor placements."""
    values, axes = model.input_specs(shape)
    return shard_tree(rules, axes, values)


def cache_shardings(model: ModelDef, rules: MeshRules, B: int, seq_len: int):
    """(the cache's DTensor placements, the cache on the meta device)."""
    values, axes = model.abstract_cache(B, seq_len)
    return shard_tree(rules, axes, values), values


def make_prefill_step(model: ModelDef, rules: Optional[MeshRules] = None):
    model.fsdp_specs(rules)

    def prefill_step(params, batch, cache_len=None):
        tokens = torch.as_tensor(batch["tokens"]).to(device=params["embed"].device,
                                                     dtype=torch.int64)
        return model.prefill(params, tokens, rules, cache_len=cache_len,
                             frames=batch.get("frames"), image_embeds=batch.get("image_embeds"))

    return prefill_step


def make_decode_step(model: ModelDef, rules: Optional[MeshRules] = None):
    model.fsdp_specs(rules)

    def decode_step(params, tokens, pos, caches):
        return model.decode(params, tokens, pos, caches, rules)

    return decode_step
