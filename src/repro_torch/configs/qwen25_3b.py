"""qwen2.5-3b: 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936,
QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab=151936,
        mlp="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
        source="hf:Qwen/Qwen2.5; hf",
    )
)
