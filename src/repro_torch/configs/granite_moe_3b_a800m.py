"""granite-moe-3b-a800m — the moe family's serving model of the port:
every layer's FFN is a router-weighted sum over the top 8 of 40 small
SwiGLU experts.

32 layers, d_model 1536, 24 query heads over 8 KV heads (GQA groups of
3), head_dim 64, vocab 49,155, RMSNorm, RoPE θ = 10,000, tied
embeddings; 40 experts of d_ff 512, top-8, the "dense" router (a
token's FFN output is the sum over every expert weighted by its top-k
combine weight, 0 where not selected; the port's kernel computes only
the weighted pairs), routing groups of 2048 tokens: about 3.3 B
parameters (~6.6 GB in bf16), the dimensions of the granite-3.0-3b-a800m
model card.  Weights are drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

GRANITE_MOE_3B = register(
    ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        head_dim=64,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="hf:ibm-granite/granite-3.0-3b-a800m-base model card",
        moe=MoEConfig(
            num_experts=40,
            top_k=8,
            d_ff_expert=512,
            capacity_factor=1.25,
            router_impl="dense",
            router_group=2048,
        ),
        window_for_long=8192,
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=4,
    )
)
