"""Fixture: impurity two hops down the call graph, through a
``torch.utils.checkpoint.checkpoint`` call-form root and a same-module
helper: the block recomputed in the backward reads the wall clock."""
import time

from torch.utils.checkpoint import checkpoint


def jitter(x):
    return x * time.time()  # traced-purity violation


def block(x):
    return jitter(x) + 1


def forward(x):
    return checkpoint(block, x, use_reentrant=False)
