"""Architecture registry of the port: the reference's eleven archs (the
lstm, dense, moe, ssm, hybrid, encdec and vlm families)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    SHAPE_REGISTRY,
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_arch,
    get_shape,
    register,
)
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    granite_moe_3b_a800m,
    hymba_1_5b,
    internvl2_2b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    phi3_medium_14b,
    smollm_360m,
    stablelm_12b,
    swb2000_blstm,
    whisper_large_v3,
)

ALL_ARCHS = tuple(sorted(ARCH_REGISTRY))
ASSIGNED_ARCHS = tuple(a for a in ALL_ARCHS if a != "swb2000-blstm")
