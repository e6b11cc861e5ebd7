"""Fixture: an autograd Function whose backward reseeds torch's global
RNG through a helper: every backward resets the stream that the rest of
the process draws from."""
import torch


def _reset():
    torch.manual_seed(0)  # traced-purity violation


class _Reseed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        _reset()
        return g * 2
