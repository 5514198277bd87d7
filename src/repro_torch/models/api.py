"""Model facade: one interface over the ported families — the port of
``repro.models.api`` for the dense, moe, ssm, hybrid, vlm, encdec and
lstm families.

``build_model(cfg)`` returns a :class:`Model` exposing ``param_specs()``,
``prefill_fn`` / ``decode_fn`` (serving steps: the dense, moe and vlm
families over a dense or paged KV cache — a moe layer's FFN is a mixture
of experts, the fused dense-MoE kernel on the card under the dense
router; a vlm prefill may prefix ``batch['patches']`` to the tokens —
the ssm family over per-slot conv windows and SSM states, the hybrid
family over both: a dense KV cache and the SSM states; the encdec family
(``models/encdec.py``) encodes ``batch['frames']`` and decodes over a
self and a cross cache, never paged), ``cache_specs(batch, cache_len)``
(encdec: also ``enc_len``, the encoder frames; ``cache_len`` by default,
the reference's even split) and ``page_specs(n_pages, page_size)``
(attention-only: ValueError for the ssm, hybrid and encdec families).
The lstm family has parameters but no decode loop; its ASR server calls
``models/lstm.py`` directly.  ``loss_fn(params, batch)`` is every
family's training loss: over learner-stacked params and a batch split
over learners (the train step's call) the (L,) per-learner losses, for
one model's params and batch the scalar.  ``input_specs(shape, mode)``
is the spec tree of a step's inputs at an assigned shape (shapes,
dtypes, logical axes), and ``cache_specs`` also takes a
:class:`~repro_torch.configs.base.ShapeConfig`, as the reference's does;
the dry-run (``launch/dryrun.py``) builds its stand-ins from both.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import lstm as LS
from repro_torch.models import transformer as TF
from repro_torch.params import ParamSpec


def _i32(shape, axes):
    return ParamSpec(shape, "int32", "zeros", axes=axes)


def _emb(shape, axes):
    return ParamSpec(shape, "bfloat16", "normal", 1.0, axes)


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    # the learner-folded expert weights a moe model keeps on the card from
    # one training call to the next (kernels/moe_dense.fold_experts)
    folds: dict = field(default_factory=dict, compare=False, repr=False)

    def param_specs(self):
        fam = self.cfg.family
        if fam == "encdec":
            return ED.param_specs(self.cfg)
        if fam == "lstm":
            return LS.param_specs(self.cfg)
        return TF.param_specs(self.cfg)

    def loss_fn(self, params, batch, *, denominator=None):
        """The family's training loss (``models/transformer.loss_train``,
        ``models/encdec.loss_train`` or ``models/lstm.loss_train``, the
        last on the device the params lie on); ``denominator``: see
        ``models/common.cross_entropy``."""
        fam = self.cfg.family
        if fam == "encdec":
            return ED.loss_train(self.cfg, params, batch,
                                 denominator=denominator)
        if fam == "lstm":
            dev = params["softmax_b"].device
            return LS.loss_train(self.cfg, params, batch, device=dev,
                                 denominator=denominator)
        return TF.loss_train(self.cfg, params, batch, keep=self.folds,
                             denominator=denominator)

    def _decoder(self):
        if not self.cfg.supports_decode:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) has no "
                             f"prefill/decode loop")

    def prefill_fn(self, params, batch, *, cache_len: int = 0,
                   long_context: bool = False):
        """``long_context`` gives a full-attention arch its documented
        sliding window (``transformer.layer_windows``; the encdec family
        takes none, as in the reference)."""
        self._decoder()
        if self.cfg.family == "encdec":
            return ED.prefill(self.cfg, params, batch["frames"],
                              batch["tokens"], cache_len=cache_len)
        return TF.prefill(self.cfg, params, batch["tokens"],
                          cache_len=cache_len, patches=batch.get("patches"),
                          long_context=long_context)

    def decode_fn(self, params, cache, tokens, pos, *, page_table=None,
                  page_size: int = 0, long_context: bool = False):
        self._decoder()
        if self.cfg.family == "encdec":
            if page_table is not None:
                raise ValueError("paged KV cache: decoder-only families")
            return ED.decode_step(self.cfg, params, cache, tokens, pos)
        return TF.decode_step(self.cfg, params, cache, tokens, pos,
                              page_table=page_table, page_size=page_size,
                              long_context=long_context)

    def cache_specs(self, batch, cache_len: int = 0, enc_len: int = 0):
        """Decode-state specs of ``batch`` slots of ``cache_len``
        positions (encdec: and ``enc_len`` encoder frames, by default
        ``cache_len``); or, given a :class:`ShapeConfig` as ``batch``,
        the reference's ``cache_specs(shape)``: its global batch at its
        sequence length (encdec: half of it each, self and cross)."""
        self._decoder()
        if isinstance(batch, ShapeConfig):
            shape = batch
            batch, cache_len = shape.global_batch, shape.seq_len
            if self.cfg.family == "encdec":
                cache_len = enc_len = shape.seq_len // 2
        if self.cfg.family == "encdec":
            return ED.cache_specs(self.cfg, batch, cache_len,
                                  enc_len or cache_len)
        return TF.cache_specs(self.cfg, batch, cache_len)

    def input_specs(self, shape: ShapeConfig, mode: str = None) -> dict:
        """The spec tree of a step's inputs at ``shape``
        (``repro.models.api.Model.input_specs``): mode 'train' |
        'prefill' | 'decode' (default ``shape.kind``).  Tokens and labels
        int32, frames, features and patches bf16, each with its logical
        axes; decode takes one token a row and a scalar position."""
        cfg = self.cfg
        mode = mode or shape.kind
        B, S = shape.global_batch, shape.seq_len
        fam = cfg.family
        if fam == "lstm":
            if mode != "train":
                raise ValueError("the frame classifier has no decode or "
                                 "prefill")
            return {"features": _emb((B, S, cfg.input_dim),
                                     ("batch", "seq", "feature")),
                    "labels": _i32((B, S), ("batch", "seq"))}
        decode = {"tokens": _i32((B, 1), ("batch", None)),
                  "pos": _i32((), ())}
        if fam == "encdec":
            if mode == "decode":
                return decode
            half = S // 2
            d = {"frames": _emb((B, half, cfg.d_model),
                                ("batch", "frames", "embed")),
                 "tokens": _i32((B, half), ("batch", "seq"))}
            if mode == "train":
                d["labels"] = _i32((B, half), ("batch", "seq"))
            return d
        if mode == "decode":
            return decode
        st = S
        d = {}
        if fam == "vlm":
            sp = int(S * cfg.vlm_patch_frac)
            st = S - sp
            d["patches"] = _emb((B, sp, cfg.d_model),
                                ("batch", "seq", "embed"))
        d["tokens"] = _i32((B, st), ("batch", "seq"))
        if mode == "train":
            d["labels"] = _i32((B, st), ("batch", "seq"))
        return d

    def page_specs(self, n_pages: int, page_size: int):
        """Paged decode-state specs (one shared page pool; serve.py
        ``--cache paged``); ValueError for a family without attention or
        with an encoder."""
        self._decoder()
        if self.cfg.family == "encdec":
            raise ValueError("paged KV cache: decoder-only families")
        return TF.page_specs(self.cfg, n_pages, page_size)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
