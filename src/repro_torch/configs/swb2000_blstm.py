"""swb2000-blstm — the paper's own acoustic model (§V Experiments).

6 bi-directional LSTM layers with 1,024 cells each (512 per direction), a
256-unit linear bottleneck, and a 32,000-way softmax over CD-HMM states.
Input is a 260-dim acoustic feature vector.  [Cui et al., IEEE SPM 2020,
§V]
"""
from repro_torch.configs.base import ArchConfig, register

SWB2000_BLSTM = register(
    ArchConfig(
        name="swb2000-blstm",
        family="lstm",
        n_layers=6,
        d_model=1024,          # LSTM cells per layer (512 per direction)
        vocab=32000,           # CD-HMM state targets
        citation="Cui et al., IEEE Signal Processing Magazine 2020, §V",
        norm="none",
        tie_embeddings=False,
        lstm_hidden=512,       # per direction
        lstm_bottleneck=256,
        input_dim=260,
        beam_width=8,
        beam_semiring="max",
        # frame classifier: no autoregressive decode step
        skip_shapes=("prefill_32k", "decode_32k", "long_500k"),
        train_strategy="ad_psgd",
        n_learners=16,
        microbatches=1,
    )
)
