"""olmoe-1b-7b: 16L d_model=2048 16H (MHA kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        mlp="swiglu",
        moe=True,
        n_experts=64,
        top_k=8,
        source="arXiv:2409.02060; hf",
    )
)
