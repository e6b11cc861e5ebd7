"""Carry the reference model's weights into the port.

``from_jax_values(values, cfg)`` takes the ``params`` values tree of
``repro.models.build_model(cfg).init(key)`` (after ``split_params``) as
nested dicts of **numpy** arrays, so this module never touches jax: the
caller does the ``np.asarray``. The reference stacks each block's weights
along a leading repeat axis under ``stack{i}/b{j}`` (stack i repeats its
pattern unit, b{j} is the unit's j-th block); the port keeps one dict per
layer in model order: every repeat of stack 0's unit, then stack 1's. An
MoE layer's ``ffn`` keeps the reference's leaves: ``router`` (d, E), the
experts' ``wg`` / ``wu`` (E, d, f) and ``wo`` (E, f, d) with the expert
axis first, and a ``shared`` sub-tree when the config has shared experts.

Leaves the reference uses in float32 arithmetic without
``.astype(x.dtype)`` stay float32: the norms, the rwkv time-mix's
``models.rwkv6.F32_KEYS`` and the RG-LRU's ``models.rglru.F32_KEYS`` (the
same tuples the models' ``init`` reads). Every other weight is cast to the
activation dtype, as the reference casts it at use, so the products are
the same; training asks for ``param_dtype=torch.float32`` instead, the
reference's own storage type (the layers cast at use).

``train_state_from_jax`` carries the reference's train state (``params``,
``opt``, ``step``[, ``efb``], numpy leaves) into the port's: the optimizer
state and the error feedback keep the reference's stacked layout (see
``repro_torch.train.optim``), so they convert leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, rwkv6
from repro_torch.models.model_api import _stacks_for, activation_dtype, build_model

_NORM_KEYS = ("ln1", "ln2", "final_ln")
#: float32 leaves by the sub-tree that holds them
F32_LEAVES = {"tm": rwkv6.F32_KEYS, "rec": rglru.F32_KEYS}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=device)


def _convert(tree: Dict[str, Any], dtype, device, layer=None, f32=()) -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            dt = torch.float32 if key in _NORM_KEYS else dtype
            out[key] = _convert(val, dt, device, layer, F32_LEAVES.get(key, ()))
        else:
            dt = torch.float32 if key in f32 else dtype
            out[key] = _tensor(val if layer is None else val[layer], dt, device)
    return out


def from_jax_values(values: Dict[str, Any], cfg: ArchConfig, device="cpu",
                    param_dtype=None) -> Dict[str, Any]:
    """The reference's values tree (numpy leaves) -> the port's parameters,
    matrices in ``param_dtype`` (default: the activation dtype)."""
    build_model(cfg)  # raises for a configuration the port does not run
    dt = param_dtype or activation_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": _tensor(values["embed"], dt, device),
        "final_ln": _convert(values["final_ln"], torch.float32, device),
        "layers": [
            _convert(values[f"stack{si}"][f"b{j}"], dt, device, layer=rep)
            for si, (unit, reps) in enumerate(_stacks_for(cfg))
            for rep in range(reps)
            for j in range(len(unit))
        ],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(values["lm_head"], dt, device)
    return params


def _float32_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _float32_tree(v, device) for k, v in tree.items()}
    return _tensor(tree, torch.float32, device)


def train_state_from_jax(state: Dict[str, Any], cfg: ArchConfig, device="cpu") -> Dict[str, Any]:
    """The reference's ``make_train_step`` state with numpy leaves -> the
    port's: float32 parameters, the float32 optimizer state and error
    feedback in the reference's stacked layout, the step an int32 tensor."""
    out = {
        "params": from_jax_values(state["params"], cfg, device, param_dtype=torch.float32),
        "opt": _float32_tree(state["opt"], device),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }
    if "efb" in state:
        out["efb"] = _float32_tree(state["efb"], device)
    return out


def predictor_from_jax(params: Dict[str, Any], mu, sd, threshold: float):
    """The reference ``FailurePredictor``'s ``params`` ({"w": (F,), "b": ()}),
    ``mu``, ``sd`` and ``threshold``, as numpy -> the port's predictor, on
    the CPU."""
    from repro_torch.core.predictor import FailurePredictor

    return FailurePredictor(
        threshold=float(threshold),
        params={k: _tensor(params[k], torch.float32, "cpu") for k in ("w", "b")},
        mu=np.asarray(mu, np.float32),
        sd=np.asarray(sd, np.float32),
    )
