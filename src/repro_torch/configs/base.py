"""Architecture configuration: the port's own copy of the fields of
``repro.configs.base.ArchConfig`` (and of its ``MoEConfig`` and
``SSMConfig``) that the lstm, dense, moe, ssm and hybrid families read.

Configs are frozen dataclasses so they compare and hash by value.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int          # hidden dim of each expert FFN
    shared_expert: bool = False
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_impl: str = "dispatch"   # "dispatch" (capacity one-hot) | "dense"
    aux_loss_weight: float = 0.01
    router_group: int = 4096        # tokens per routing group for dispatch


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 style SSD (state space duality) block configuration."""

    state_dim: int            # N, per-head SSM state size
    head_dim: int = 64        # P, channels per SSM head
    expand: int = 2           # d_inner = expand * d_model
    n_groups: int = 1         # B/C groups (like GQA for SSM)
    conv_width: int = 4       # depthwise causal conv width
    chunk: int = 256          # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    """One selectable architecture (``--arch <name>``)."""

    name: str
    family: str               # "lstm" | "dense" | "moe" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    vocab: int
    citation: str = ""

    # decoder-only transformer (the dense family)
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0         # 0 -> derived as d_model // n_heads
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"     # rmsnorm | layernorm | none
    act: str = "swiglu"       # swiglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = True
    # sliding-window attention (0 = full); the layers that keep global
    # attention when a window is active; the documented long-context
    # variant of full-attention archs
    window: int = 0
    window_for_long: int = 8192
    global_attn_layers: tuple = ()

    # the MoE FFN of the moe family's layers (models/moe.py)
    moe: Optional[MoEConfig] = None
    # the SSM block of the ssm family and of the hybrid family's layers
    # (models/ssm.py)
    ssm: Optional[SSMConfig] = None

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
    # (0 = per-step stash; K > 0 frames per chunk, -1 = auto)
    lstm_stash_dtype: str = "float32"
    lstm_seq_chunk: int = 0

    # distribution defaults (core/strategies.py)
    train_strategy: str = "sd_psgd"
    n_learners: int = 16
    # communication substrate (core/transport.py): mixing topology / wire
    # codec overrides, "" = the strategy's default
    comm_topology: str = ""
    comm_wire: str = ""
    # hierarchical only: codec of the intra-pod allreduce ("" = f32;
    # f32 | bf16 | int8, topk is gossip-only); the inter-pod ring uses
    # comm_wire, e.g. bf16 intra + topk inter
    comm_intra_wire: str = ""
    # split payloads into buckets of this many MB, each coded on its own
    # (0 = one payload per tensor)
    comm_bucket_mb: int = 0
    # hierarchical topology: learners per pod (must divide n_learners)
    comm_pod_size: int = 1
    # topk wire: fraction of entries shipped per bucket
    comm_topk_frac: float = 0.01
    # elastic mixing only (the fault-tolerant step, --fault-* runs): a
    # learner s steps behind mixes with confidence 1/(1 + λ·s)
    # (mixing.staleness_damped, through Transport.staleness_lambda)
    comm_staleness_lambda: float = 0.0

    # serving KV-cache layout (launch/serve.py --cache): 'dense' per-slot
    # max_len rows | 'paged' shared page pool with prompt-prefix sharing
    # and COW; cache positions per page under 'paged'
    cache_mode: str = "dense"
    page_size: int = 16

    param_dtype: str = "bfloat16"
    microbatches: int = 4     # gradient-accumulation microbatches for train
    # the reference config's switch for its fused dense-MoE math; it selects
    # nothing in the port (models/moe.py runs one kernel on every device)
    # and is kept so that a config maps onto the reference's one to one
    moe_dense_fused: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def supports_decode(self) -> bool:
        return self.family != "lstm"   # frame classifier has no decode loop

    def reduced(self) -> "ArchConfig":
        """The reference's smoke-test variant: 2 layers, d_model <= 256,
        <= 4 heads, <= 2 KV heads, head_dim max(d // heads, 8), d_ff <=
        512, vocab <= 512, hidden 64, bottleneck 32, 2 learners, 1
        microbatch; an MoE keeps <= 4 experts, top-k <= 2, d_ff_expert and
        shared_d_ff <= 128 and routing groups of 64; an SSM keeps
        state_dim <= 16 with head_dim 16 and chunk 16."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) or self.n_heads
        kv = min(self.n_kv_heads, 2) or self.n_kv_heads
        changes = dict(n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv,
                       head_dim=max(d // max(heads, 1), 8) if heads else 0,
                       d_ff=min(self.d_ff, 512) if self.d_ff else 0,
                       vocab=min(self.vocab, 512), n_learners=2,
                       microbatches=1,
                       window=min(self.window, 64) if self.window else 0)
        if self.moe is not None:
            changes["moe"] = replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                shared_d_ff=min(self.moe.shared_d_ff, 128), router_group=64)
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm,
                                     state_dim=min(self.ssm.state_dim, 16),
                                     head_dim=16, chunk=16)
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
