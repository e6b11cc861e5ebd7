"""rwkv6-1.6b (Finch): 24L d_model=2048, attention-free, data-dependent decay,
d_ff=7168 vocab=65536. Head size 64 -> 32 heads. [arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads: d_model / head_size(64)
        n_kv_heads=32,
        d_ff=7168,
        vocab=65536,
        head_dim=64,
        mlp="rwkv_channel_mix",
        attn_free=True,
        source="arXiv:2404.05892",
    )
)
