"""Fixture: a dtype-less constructor in the float64 fold (the test lints
it at ``repro_torch/scenarios/trajectory.py``): the tensor is float32,
torch's default, and shears the fold's accumulators off the engine's
float64."""
import torch


def build_state(n_hosts):
    return torch.zeros(n_hosts)  # dtype-x64 violation
