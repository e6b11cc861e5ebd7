"""Step factories (counterpart of ``repro/train/step.py``): the train step
(loss, gradient, optimizer update), the prefill step and the decode step.

The reference's factories also return sharding and abstract-input helpers
for its multi-pod dry run; those wait for the port's ``sharding/`` slice
(ROADMAP.md Queue 1, item 9). The steps run eagerly.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_api import ModelDef, _stacks_for
from repro_torch.train.optim import compress_grads_int8, init_error_fb, make_optimizer
from repro_torch.utils.tree import flatten, unflatten


def make_train_step(model: ModelDef, lr: float = 1e-4, grad_compression: bool = False):
    """Returns (train_step, init_state).

    state = {"params": float32 masters, "opt": optimizer state, "step": int32
    tensor[, "efb": error feedback]}; ``train_step(state, batch)`` returns
    (new state, {"loss": loss}). The update is written into the state's
    tensors (see ``train.optim``): the returned state holds the same
    tensors, and a caller that must keep the old values copies them first.
    ``init_state(gen)`` draws the parameters from the torch Generator
    ``gen`` on its device."""
    stacks = _stacks_for(model.cfg)
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, stacks, lr=lr)

    def train_step(state, batch):
        leaves, treedef = flatten(state["params"])
        live = [p.detach().requires_grad_() for p in leaves]
        loss = model.loss(unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        grads = unflatten(treedef, list(grads))
        del live
        new_state = {}
        if grad_compression:
            grads, new_state["efb"] = compress_grads_int8(grads, state["efb"], stacks)
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


def make_prefill_step(model: ModelDef):
    def prefill_step(params, batch, cache_len=None):
        tokens = torch.as_tensor(batch["tokens"]).to(device=params["embed"].device,
                                                     dtype=torch.int64)
        return model.prefill(params, tokens, cache_len=cache_len)

    return prefill_step


def make_decode_step(model: ModelDef):
    def decode_step(params, tokens, pos, caches):
        return model.decode(params, tokens, pos, caches)

    return decode_step
