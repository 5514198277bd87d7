"""smollm-360m — a llama-architecture decoder-only LM, the dense family's
serving model of the port.

32 layers, d_model 960, 15 query heads over 5 KV heads (GQA groups of 3),
head_dim 64, SwiGLU d_ff 2560, vocab 49,152, RMSNorm, RoPE θ = 10,000,
tied embeddings: the dimensions of HuggingFaceTB/SmolLM-360M's published
``config.json``.  Weights are drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

SMOLLM_360M = register(
    ArchConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab=49152,
        head_dim=64,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="hf:HuggingFaceTB/SmolLM-360M (llama architecture family)",
        window_for_long=8192,
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=2,
    )
)
