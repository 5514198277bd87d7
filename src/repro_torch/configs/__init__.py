"""Architecture registry of the port (the lstm and dense families)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    get_arch,
    register,
)
from repro_torch.configs import smollm_360m, swb2000_blstm  # noqa: F401
