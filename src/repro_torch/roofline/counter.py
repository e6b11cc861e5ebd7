"""FLOPs, bytes and collectives of one eager step on one rank: the port's
counterpart of ``repro/roofline/hlo.py::module_stats``.

The reference reads its numbers from the compiled, SPMD-partitioned HLO of
a step: FLOPs of every ``dot``, bytes at fusion boundaries, and the operand
bytes of every collective. The port has no compiled module. Its step runs
eagerly, op by op, on this rank's shards, and :class:`StepCounter` is a
``TorchDispatchMode`` over that run that counts:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s aten formulas
  (matrix products, convolutions, attention) plus what each hand-written
  kernel reports through :func:`kernel` (its bound's formula, the one
  ``chip_smoke.bound`` and ``PERF.md`` §6 state);
- ``bytes``: every aten op's inputs and outputs once each, and each
  kernel's reported bytes. The count is eager and unfused: an elementwise
  chain that a compiler would fuse counts each intermediate twice (written,
  then read), so it is an upper end of the traffic the same work needs,
  not the reference's post-fusion figure. Views, metadata ops and empty
  allocations move nothing and are not counted;
- ``collectives``: by the reference's kinds, each with ``count``,
  ``operand_bytes`` and ``wire_bytes`` under the reference's ring
  multipliers (:data:`MULTIPLIER`), and ``_total``. They are reported by
  :mod:`repro_torch.sharding.collectives` through :func:`collective`.

Counters nest in a stack; :func:`kernel` and :func:`collective` add to the
innermost open one and do nothing when none is open, so a real run pays one
list test.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: bytes on the wire a byte of operand, ring algorithms (the reference's)
MULTIPLIER = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0, "all-to-all": 1.0,
              "collective-permute": 1.0}

_open: List["StepCounter"] = []

_aten = torch.ops.aten
#: ops that allocate or describe a tensor without moving its data
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
               _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
               _aten.lift_fresh.default, _aten.sym_size.int, _aten.sym_stride.int,
               _aten.sym_numel.default, _aten.sym_storage_offset.default,
               _aten.is_same_size.default, _aten._local_scalar_dense.default}


def active() -> Optional["StepCounter"]:
    """The innermost open counter, or None."""
    return _open[-1] if _open else None


def kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's call of ``flops`` operations moving ``nbytes``."""
    if _open:
        _open[-1].add_kernel(name, flops, nbytes)


def collective(kind: str, operand_bytes: float) -> None:
    """One collective of ``kind`` on an operand of ``operand_bytes``."""
    if _open:
        _open[-1].add_collective(kind, operand_bytes)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step()``, then ``c.stats()``."""

    def __init__(self):
        super().__init__()
        self._flops = FlopCounterMode(display=False)
        self.aten_bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.coll = {k: {"count": 0.0, "operand_bytes": 0.0, "wire_bytes": 0.0}
                     for k in COLLECTIVES}

    def __enter__(self):
        self._flops.__enter__()
        _open.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _open.remove(self)
        self._flops.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _NO_TRAFFIC and not func.is_view:
            self.aten_bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)

    def add_collective(self, kind: str, operand_bytes: float) -> None:
        c = self.coll[kind]
        c["count"] += 1
        c["operand_bytes"] += float(operand_bytes)
        c["wire_bytes"] += float(operand_bytes) * MULTIPLIER[kind]

    def stats(self) -> Dict:
        """{"flops", "bytes", "aten_flops", "kernel_flops", "kernels",
        "collectives" (every kind and "_total")}."""
        aten_flops = float(self._flops.get_total_flops())
        kflops = sum(k["flops"] for k in self.kernels.values())
        kbytes = sum(k["bytes"] for k in self.kernels.values())
        coll = {k: dict(v) for k, v in self.coll.items()}
        coll["_total"] = {f: sum(v[f] for v in self.coll.values())
                          for f in ("count", "operand_bytes", "wire_bytes")}
        return {"flops": aten_flops + kflops, "bytes": self.aten_bytes + kbytes,
                "aten_flops": aten_flops, "kernel_flops": kflops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}, "collectives": coll}
