"""kimi-k2-1t-a32b: 61L d_model=7168 64H (GQA kv=8) head_dim=112 expert
d_ff=2048 vocab=163840, MoE 384 experts top-8 + 1 shared expert. 1T total /
32B active parameters, bf16 masters, Adafactor and FSDP of every leaf over
the data axes (the reference's values). [arXiv:2501.kimi2]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab=163840,
        head_dim=112,
        mlp="swiglu",
        moe=True,
        n_experts=384,
        top_k=8,
        n_shared_experts=1,
        optimizer="adafactor",
        fsdp=True,
        param_dtype="bfloat16",
        source="arXiv:2501.kimi2 (paper-table)",
    )
)
