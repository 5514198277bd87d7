"""llama4-scout-17b-a16e — the moe family's dispatch-router model: 16
experts, top-1, beside a shared expert in every layer.

48 layers, d_model 5120, 40 query heads over 8 KV heads, head_dim 128,
vocab 202,048, RMSNorm, RoPE θ = 500,000, tied embeddings; 16 SwiGLU
experts and one shared expert, each of d_ff 8192, the capacity
("dispatch") router with capacity factor 1.25 over routing groups of
4096 tokens; sliding-window attention of 8192 positions except in layers
0, 12, 24 and 36.  About 107 B parameters (~214 GB in bf16): one 80 GB
card cannot hold it, so the port serves it at the reduced width only
(``launch/serve.py`` refuses the full width).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

LLAMA4_SCOUT = register(
    ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        head_dim=128,
        rope_theta=500_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E model card",
        moe=MoEConfig(
            num_experts=16,
            top_k=1,
            d_ff_expert=8192,
            shared_expert=True,
            shared_d_ff=8192,
            capacity_factor=1.25,
            router_impl="dispatch",
            router_group=4096,
        ),
        window=8192,
        global_attn_layers=(0, 12, 24, 36),
        train_strategy="sc_psgd",
        n_learners=1,
        fsdp=True,
        expert_axis="data",
        microbatches=8,
    )
)
