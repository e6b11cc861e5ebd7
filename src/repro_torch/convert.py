"""Carry the reference model's weights into the port.

``from_jax_values(values, cfg)`` takes the ``params`` values tree of
``repro.models.build_model(cfg).init(key)`` (after ``split_params``) as
nested dicts of **numpy** arrays, so this module never touches jax: the
caller does the ``np.asarray``. The reference stacks each block's weights
along a leading layer axis under ``stack0/b0``; the port keeps one dict per
layer. Norm parameters stay float32, every other weight is cast to the
activation dtype (the reference casts them with ``.astype(x.dtype)`` at
use, so the products are the same).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model_api import activation_dtype, build_model

_NORM_KEYS = ("ln1", "ln2", "final_ln")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=device)


def _convert(tree: Dict[str, Any], dtype, device, layer=None) -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            dt = torch.float32 if key in _NORM_KEYS else dtype
            out[key] = _convert(val, dt, device, layer)
        else:
            out[key] = _tensor(val if layer is None else val[layer], dtype, device)
    return out


def from_jax_values(values: Dict[str, Any], cfg: ArchConfig, device="cpu") -> Dict[str, Any]:
    """The reference's values tree (numpy leaves) -> the port's parameters."""
    build_model(cfg)  # raises for a configuration the port does not run
    dt = activation_dtype(cfg)
    stack = values["stack0"]["b0"]
    params: Dict[str, Any] = {
        "embed": _tensor(values["embed"], dt, device),
        "final_ln": _convert(values["final_ln"], torch.float32, device),
        "layers": [_convert(stack, dt, device, layer=i) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(values["lm_head"], dt, device)
    return params
