"""whisper-tiny: enc-dec, 4L encoder + 4L decoder, d_model=384 6H d_ff=1536
vocab=51865. Conv/audio frontend is a STUB: ``input_specs`` provides 1500
precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        mlp="gelu",
        norm="layer",
        qkv_bias=True,
        encoder_layers=4,
        encoder_seq=1500,
        source="arXiv:2212.04356",
    )
)
