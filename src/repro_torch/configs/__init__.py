from repro_torch.configs.base import (
    ArchConfig,
    SHAPES,
    ShapeCfg,
    all_archs,
    get_arch,
    register,
)
