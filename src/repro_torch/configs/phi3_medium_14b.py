"""phi3-medium-14b — a dense decoder of the port.

40 layers, d_model 5120, 40 query heads over 10 KV heads (GQA groups of
4), head_dim 128, SwiGLU d_ff 17,920, vocab 100,352, RMSNorm, RoPE θ =
10,000, tied embeddings: the dimensions of arXiv:2404.14219 as the
reference configures them (28.3 GB of bf16 weights).  Weights are drawn
from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

PHI3_MEDIUM_14B = register(
    ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab=100352,
        head_dim=128,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="arXiv:2404.14219 (Phi-3 technical report)",
        window=0,
        window_for_long=8192,
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=8,
    )
)
