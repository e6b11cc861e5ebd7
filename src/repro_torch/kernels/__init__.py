"""Hand-written CUDA kernels (``src/repro_torch/csrc/``) and their plain
torch versions; the model calls them through :mod:`repro_torch.kernels.ops`."""
