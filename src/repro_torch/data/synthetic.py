"""Deterministic synthetic token stream for training runs (counterpart of
``repro/data/synthetic.py``).

Deterministic in (seed, step): the fault-tolerant trainer's lossless
invariant (a bit-identical final state under failures) needs a pipeline
that replays from any step. The reference draws with jax's threefry, which
no torch or numpy generator reproduces, so the port draws with numpy's
PCG64 seeded by (seed, step); parity tests feed both packages the same
numpy batches.
"""
from __future__ import annotations

import numpy as np


def token_batches(seed: int, batch: int, seq: int, vocab: int):
    """Returns make_batch(step) -> {'tokens': (batch, seq) int32 numpy}."""

    def make_batch(step: int):
        rng = np.random.default_rng([seed, step])
        return {"tokens": rng.integers(0, vocab, (batch, seq), dtype=np.int32)}

    return make_batch
