"""hymba-1.5b — the hybrid family's serving model of the port: every
layer runs attention heads and Mamba-2 SSM heads side by side on the
same normed input, normalises each branch's output and averages them.

32 layers, d_model 1600, 25 query heads over 5 KV heads (GQA groups of
5), head_dim 64, SwiGLU d_ff 5504, vocab 32,001, RMSNorm, RoPE θ =
10,000, tied embeddings; sliding-window attention of 1024 positions
except in the first, middle and last layers (0, 15, 31), which keep
global attention; the SSM branch has d_inner 3200 (expand 2) as 50 heads
of P = 64, state N = 16 in one B/C group, causal conv width 4, SSD chunk
256: about 1.6 B parameters, the dimensions of arXiv:2411.13676.
Weights are drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

HYMBA_1_5B = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="arXiv:2411.13676 (Hymba)",
        ssm=SSMConfig(
            state_dim=16,
            head_dim=64,
            expand=2,          # d_inner = 3200, 50 SSM heads
            n_groups=1,
            conv_width=4,
            chunk=256,
        ),
        window=1024,
        global_attn_layers=(0, 15, 31),
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=2,
    )
)
