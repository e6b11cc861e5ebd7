"""recurrentgemma-9b (griffin): 38 blocks d_model=4096 16H (MQA kv=1)
d_ff=12288, RG-LRU + local attention (window 2048), pattern
(rec, rec, attn) x 12 + (rec, rec). [arXiv:2402.19427]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        head_dim=256,
        mlp="geglu",
        block_pattern=("rec", "rec", "attn"),
        window=2048,
        lru_width=4096,
        conv_width=4,
        tie_embeddings=True,
        source="arXiv:2402.19427",
    )
)
