"""Fixture: float32 creeping into the float64 fold (the test lints it at
``repro_torch/scenarios/montecarlo.py``): a narrow cast and a narrow dtype
literal."""
import torch


def fold(lost, t):
    lost = lost + t.float()  # dtype-x64 violation: narrow cast
    return lost.to(torch.float32)  # dtype-x64 violation: narrow literal
