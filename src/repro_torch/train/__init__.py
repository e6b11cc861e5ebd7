"""Training (counterpart of ``repro/train``): step factories and optimizers."""
