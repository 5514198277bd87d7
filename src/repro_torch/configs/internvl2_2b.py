"""internvl2-2b — the vlm family's model of the port: a dense decoder
whose prefill may prefix image patch embeddings to the text tokens.

24 layers, d_model 2048, 16 query heads over 8 KV heads (GQA groups of
2), head_dim 128, SwiGLU d_ff 8192, vocab 92,553, RMSNorm, RoPE θ =
10,000, tied embeddings: the InternLM2-1.8B language backbone of
arXiv:2404.16821.  The InternViT encoder and its MLP projector are a
stub, as in the reference: the prefill takes precomputed patch
embeddings (B, S_patch, d_model).  Weights are drawn from a seed;
nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_2B = register(
    ArchConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        head_dim=128,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="swiglu",
        tie_embeddings=True,
        citation="arXiv:2404.16821 (InternVL2); LM backbone InternLM2-1.8B",
        frontend="vision",
        vlm_patch_frac=0.25,
        window_for_long=8192,
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=4,
    )
)
