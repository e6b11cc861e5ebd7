"""Fixture: an in-place draw from the global torch RNG in a block that
``torch.utils.checkpoint`` recomputes in the backward, one ``self.``
call down from the checkpointed method."""
import torch
from torch.utils.checkpoint import checkpoint


class Block(torch.nn.Module):
    def noise(self, x):
        return torch.empty_like(x).uniform_()  # traced-purity violation: no generator=

    def body(self, x):
        return x + self.noise(x)

    def forward(self, x):
        return checkpoint(self.body, x, use_reentrant=False)
