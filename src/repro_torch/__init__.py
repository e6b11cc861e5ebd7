"""PyTorch / CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package under ``src/repro/`` is the reference; this package mirrors
its module names (``configs``, ``kernels``, ``models``, ``launch``,
``orchestrator``) and imports neither ``jax`` nor ``repro``. Importing it
is cheap: submodules load on first attribute access.

The serving slice runs ``python -m repro_torch.launch.serve --arch gemma-2b
--full`` on the card, with hand-written CUDA kernels (``csrc/``) for
RMSNorm, prefill flash attention and flash decode.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("configs", "convert", "kernels", "launch", "models", "orchestrator")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
