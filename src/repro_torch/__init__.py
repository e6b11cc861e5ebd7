"""PyTorch / CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package under ``src/repro/`` is the reference; this package mirrors
its module names (``configs``, ``core``, ``data``, ``kernels``, ``models``,
``launch``, ``orchestrator``, ``strategies``, ``utils``) and imports neither
``jax`` nor ``repro``. Importing it is cheap: submodules load on first
attribute access.

The serving slices run ``python -m repro_torch.launch.serve --arch gemma-2b
--full`` (and rwkv6-1.6b, recurrentgemma-9b) on the card, with hand-written
CUDA kernels (``csrc/``) for RMSNorm, flash attention, flash decode, wkv6 and
the RG-LRU scan. The paper's path prices the fault-tolerance strategies
into Tables 1-2 (``python -m repro_torch.launch.tables``) and runs the
genome-search job under them (``python -m repro_torch.launch.genome``).
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("configs", "convert", "core", "data", "kernels", "launch", "models", "orchestrator",
               "strategies", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
