"""whisper-large-v3 — the encdec family's model of the port: a
transformer encoder over audio frame embeddings and a decoder with self-
and cross-attention.

32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64 (MHA),
GELU d_ff 5120, vocab 51,866, LayerNorm, biased projections, tied
embeddings, sinusoidal positions in both stacks (no RoPE): the
dimensions of arXiv:2212.04356 and the large-v3 model card.  The
mel-spectrogram and conv frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_enc, d_model).  Weights
are drawn from a seed; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_LARGE_V3 = register(
    ArchConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,           # decoder layers
        n_enc_layers=32,       # encoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,         # MHA (GQA kv=20 == n_heads)
        d_ff=5120,
        vocab=51866,
        head_dim=64,
        rope_theta=0.0,        # whisper uses learned/sinusoidal positions
        norm="layernorm",
        act="gelu",
        use_bias=True,
        tie_embeddings=True,
        citation="arXiv:2212.04356 (Whisper); large-v3 model card",
        frontend="audio",
        skip_shapes=("long_500k",),
        train_strategy="sd_psgd",
        n_learners=16,
        microbatches=4,
    )
)
