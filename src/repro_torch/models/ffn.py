"""Dense feed-forward blocks (SwiGLU / GELU) — the port of
``repro.models.ffn``.  Weights keep the reference's (d, ff) / (ff, d)
layouts; the products are plain matmuls (cuBLAS on the card)."""
from __future__ import annotations

import torch

from repro_torch.models.common import gelu
from repro_torch.params import ParamSpec


def ffn_param_specs(cfg, d_ff=None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {"wi": ParamSpec((d, ff), dt, "lecun"),
         "wo": ParamSpec((ff, d), dt, "lecun")}
    if cfg.act == "swiglu":
        p["wg"] = ParamSpec((d, ff), dt, "lecun")
    if cfg.use_bias:
        p["bi"] = ParamSpec((ff,), "float32", "zeros")
        p["bo"] = ParamSpec((d,), "float32", "zeros")
    return p


def ffn_apply(cfg, p, x):
    h = x @ p["wi"]
    if "bi" in p:
        h = (h.float() + p["bi"]).to(h.dtype)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"]) * h
    else:
        h = gelu(h)
    y = h @ p["wo"]
    if "bo" in p:
        y = (y.float() + p["bo"]).to(y.dtype)
    return y
