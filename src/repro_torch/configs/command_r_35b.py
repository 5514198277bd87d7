"""command-r-35b — the widest dense decoder of the port.

40 layers, d_model 8192, 64 query heads over 8 KV heads (GQA groups of
8), head_dim 128, SwiGLU d_ff 22,528, vocab 256,000, LayerNorm without
biases, RoPE θ = 10,000, tied embeddings: the CohereForAI/c4ai-command-r-
v01 model card as the reference configures it (60.57 GB of bf16
weights, which one 80 GB card holds).  Weights are drawn from a seed;
nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

COMMAND_R_35B = register(
    ArchConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab=256000,
        head_dim=128,
        rope_theta=10_000.0,
        norm="layernorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=True,
        citation="hf:CohereForAI/c4ai-command-r-v01 model card",
        window_for_long=8192,
        train_strategy="sd_psgd",
        n_learners=16,
        microbatches=8,
    )
)
