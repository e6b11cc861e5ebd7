"""deepseek-7b: 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400,
llama-arch. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
        mlp="swiglu",
        source="arXiv:2401.02954; hf",
    )
)
