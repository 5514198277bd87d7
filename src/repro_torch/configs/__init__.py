"""Architecture registry of the port (the lstm, dense, moe, ssm and
hybrid families)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_arch,
    register,
)
from repro_torch.configs import (  # noqa: F401
    granite_moe_3b_a800m,
    hymba_1_5b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    smollm_360m,
    swb2000_blstm,
)
