"""Architecture registry of the port (the lstm family so far)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    get_arch,
    register,
)
from repro_torch.configs import swb2000_blstm  # noqa: F401
