"""stablelm-12b — a dense decoder of the port, the only config with a
head_dim of 160 (the flash-attention kernel's widest instantiation).

40 layers, d_model 5120, 32 query heads over 8 KV heads (GQA groups of
4), head_dim 160, SwiGLU d_ff 13,824, vocab 100,352, LayerNorm, RoPE θ =
10,000, an untied LM head: the stabilityai/stablelm-2-12b model card as
the reference configures it (24.3 GB of bf16 weights).  Weights are
drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

STABLELM_12B = register(
    ArchConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab=100352,
        head_dim=160,
        rope_theta=10_000.0,
        norm="layernorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=False,
        citation="hf:stabilityai/stablelm-2-12b model card",
        window_for_long=8192,
        train_strategy="sd_psgd",
        n_learners=16,
        microbatches=8,
    )
)
