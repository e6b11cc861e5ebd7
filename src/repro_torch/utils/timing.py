"""Wall-clock timing helpers for the measured tier of the evaluation.

Thin compatibility layer, as in the reference: the actual timing idiom
lives in :mod:`repro_torch.obs.profile` (one ``perf_counter`` clock, one
warmup + ``torch.cuda.synchronize`` measurement discipline), and this
module re-exports it so ``utils.timing`` callers keep working."""
from __future__ import annotations

from contextlib import contextmanager

from repro_torch.obs.profile import now_s, stopwatch, timed  # noqa: F401


class Timer:
    """Accumulating named timer; .times maps name -> list of seconds."""

    def __init__(self):
        self.times = {}

    @contextmanager
    def section(self, name: str):
        try:
            with stopwatch() as sw:
                yield
        finally:
            self.times.setdefault(name, []).append(sw.s)

    def mean(self, name: str) -> float:
        xs = self.times.get(name, [])
        return sum(xs) / len(xs) if xs else 0.0

    def total(self, name: str) -> float:
        return sum(self.times.get(name, []))
