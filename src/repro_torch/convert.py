"""Carry the reference model's weights into the port.

``from_jax_values(values, cfg)`` takes the ``params`` values tree of
``repro.models.build_model(cfg).init(key)`` (after ``split_params``) as
nested dicts of **numpy** arrays, so this module never touches jax: the
caller does the ``np.asarray``. The reference stacks each block's weights
along a leading repeat axis under ``stack{i}/b{j}`` (stack i repeats its
pattern unit, b{j} is the unit's j-th block); the port keeps one dict per
layer in model order: every repeat of stack 0's unit, then stack 1's.

Leaves the reference uses in float32 arithmetic without
``.astype(x.dtype)`` stay float32: the norms, the rwkv time-mix's
``models.rwkv6.F32_KEYS`` and the RG-LRU's ``models.rglru.F32_KEYS`` (the
same tuples the models' ``init`` reads). Every other weight is cast to the
activation dtype, as the reference casts it at use, so the products are
the same.
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


def from_jax_values(values: Dict[str, Any], cfg: ArchConfig, device="cpu") -> Dict[str, Any]:
    """The reference's values tree (numpy leaves) -> the port's parameters."""
    build_model(cfg)  # raises for a configuration the port does not run
    dt = activation_dtype(cfg)
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
