"""mamba2-370m — the attention-free SSM family's serving model of the
port: Mamba-2 with the SSD (state-space duality) chunked scan.

48 layers, d_model 1024, d_inner 2048 (expand 2) as 32 SSM heads of
P = 64 channels, state N = 128 with one B/C group, causal conv width 4,
SSD chunk 256, vocab 50,280, RMSNorm, tied embeddings: about 370 M
parameters, the dimensions of the 370M model of arXiv:2405.21060.
Weights are drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

MAMBA2_370M = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,            # attention-free
        n_kv_heads=0,
        d_ff=0,               # the mamba2 block carries the MLP
        vocab=50280,
        head_dim=0,
        norm="rmsnorm",
        tie_embeddings=True,
        citation="arXiv:2405.21060 (Mamba-2 / SSD)",
        ssm=SSMConfig(
            state_dim=128,
            head_dim=64,
            expand=2,          # d_inner = 2048, 32 SSM heads
            n_groups=1,
            conv_width=4,
            chunk=256,
        ),
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=2,
    )
)
