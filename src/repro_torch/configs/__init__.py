"""Architecture registry of the port (the lstm, dense, ssm and hybrid
families)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    SSMConfig,
    get_arch,
    register,
)
from repro_torch.configs import (  # noqa: F401
    hymba_1_5b,
    mamba2_370m,
    smollm_360m,
    swb2000_blstm,
)
