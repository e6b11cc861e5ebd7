from repro_torch.configs.base import (
    ArchConfig,
    SHAPES,
    ShapeCfg,
    all_archs,
    applicable,
    get_arch,
    register,
)
