"""Fixture: the global torch RNG inside an autograd Function's forward: a
checkpointed block runs its forward again in the backward, and that draw
differs from the first one."""
import torch


class _Noisy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x + torch.randn(x.shape)  # traced-purity violation: no generator=

    @staticmethod
    def backward(ctx, g):
        return g
