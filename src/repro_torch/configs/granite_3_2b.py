"""granite-3-2b: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49155,
        mlp="swiglu",
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
)
