from repro_torch.configs.base import (
    ArchConfig,
    ShapeCfg,
    all_archs,
    get_arch,
    register,
)
