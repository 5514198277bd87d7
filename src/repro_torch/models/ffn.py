"""Dense feed-forward blocks (SwiGLU / GELU) — the port of
``repro.models.ffn``.  Weights keep the reference's (d, ff) / (ff, d)
layouts; the products are plain matmuls (cuBLAS on the card)."""
from __future__ import annotations

import torch

from repro_torch.models.common import gelu, linear, per_learner
from repro_torch.params import ParamSpec


def ffn_param_specs(cfg, d_ff=None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {"wi": ParamSpec((d, ff), dt, "lecun", axes=("embed", "mlp")),
         "wo": ParamSpec((ff, d), dt, "lecun", axes=("mlp", "embed"))}
    if cfg.act == "swiglu":
        p["wg"] = ParamSpec((d, ff), dt, "lecun", axes=("embed", "mlp"))
    if cfg.use_bias:
        p["bi"] = ParamSpec((ff,), "float32", "zeros", axes=("mlp",))
        p["bo"] = ParamSpec((d,), "float32", "zeros", axes=("embed",))
    return p


def ffn_apply(cfg, p, x):
    """x (B, S, d) -> (B, S, d); or per learner, x (L, B, S, d) against
    learner-stacked weights, one batched product per weight."""
    h = linear(x, p["wi"])
    if "bi" in p:
        h = (h.float() + per_learner(p["bi"], 1, h.dim())).to(h.dtype)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(linear(x, p["wg"])) * h
    else:
        h = gelu(h)
    y = linear(h, p["wo"])
    if "bo" in p:
        y = (y.float() + per_learner(p["bo"], 1, y.dim())).to(y.dtype)
    return y
