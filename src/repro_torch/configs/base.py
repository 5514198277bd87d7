"""Architecture configuration: the port's own copy of the fields of
``repro.configs.base.ArchConfig`` that the lstm family reads.

Configs are frozen dataclasses so they compare and hash by value.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    """One selectable architecture (``--arch <name>``)."""

    name: str
    family: str               # only "lstm" is ported so far
    n_layers: int
    d_model: int
    vocab: int
    citation: str = ""

    # lstm acoustic model (the paper's own architecture)
    lstm_hidden: int = 0      # per-direction hidden size
    lstm_bottleneck: int = 0
    input_dim: int = 0        # acoustic feature dim (paper: 260)

    # CTC prefix-beam decode (decode/beam.py)
    beam_width: int = 8
    beam_semiring: str = "max"      # 'max' (Viterbi) | 'sum' (log-semiring)
    beam_len_norm: float = 0.0      # final ranking: score / max(len,1)**a
    beam_topc: int = 0              # per-frame top-C pruning (0 = off)

    # BLSTM training kernels (kernels/lstm_cell.py): residual stash
    # precision ('float32' | 'bfloat16'); sequence-chunked recompute
    # (0 = per-step stash; K != 0 is not ported yet, ROADMAP queue 1)
    lstm_stash_dtype: str = "float32"
    lstm_seq_chunk: int = 0

    # distribution defaults (core/strategies.py)
    train_strategy: str = "sd_psgd"
    n_learners: int = 16
    # mixing topology / wire codec overrides; "" = the strategy's default
    comm_topology: str = ""
    comm_wire: str = ""

    param_dtype: str = "bfloat16"
    microbatches: int = 4     # gradient-accumulation microbatches for train

    def reduced(self) -> "ArchConfig":
        """The reference's smoke-test variant: 2 layers, d_model <= 256,
        vocab <= 512, hidden 64, bottleneck 32, 2 learners, 1
        microbatch."""
        changes = dict(n_layers=2, d_model=min(self.d_model, 256),
                       vocab=min(self.vocab, 512), n_learners=2,
                       microbatches=1)
        if self.lstm_hidden:
            changes["lstm_hidden"] = 64
            changes["lstm_bottleneck"] = 32
        return replace(self, **changes)


ARCH_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    try:
        return ARCH_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}"
        ) from None
