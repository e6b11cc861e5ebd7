"""gemma-2b: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU,
head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab=256000,
        head_dim=256,
        mlp="geglu",
        tie_embeddings=True,
        source="arXiv:2403.08295; hf",
    )
)
