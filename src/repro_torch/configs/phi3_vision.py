"""phi-3-vision-4.2b: phi3-mini backbone 32L d_model=3072 32H (MHA kv=32)
d_ff=8192 vocab=32064 + CLIP frontend STUB (``input_specs`` provides 256
precomputed patch embeddings prepended to the token stream).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        mlp="swiglu",
        num_img_tokens=256,
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )
)
