"""The paper's acoustic model: 6-layer bi-directional LSTM with a linear
bottleneck and a 32,000-way CD-HMM-state softmax (Cui et al. §V) — the
port of ``repro.models.lstm`` (inference forward).

Variable-length utterances follow the reference's ``lengths`` contract:
on padded steps (t >= lengths[b]) the (h, c) carry is frozen and the
layer output is 0, so the reverse direction reverses within each
utterance's valid span.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import blstm_layer
from repro_torch.params import ParamSpec


def layer_specs(d_in: int, hidden: int, dtype: str) -> dict:
    def direction():
        return {
            "wx": ParamSpec((d_in, 4 * hidden), dtype, "lecun"),
            "wh": ParamSpec((hidden, 4 * hidden), dtype, "lecun"),
            "b": ParamSpec((4 * hidden,), "float32", "zeros"),
        }
    return {"fwd": direction(), "bwd": direction()}


def param_specs(cfg) -> dict:
    H = cfg.lstm_hidden
    dt = cfg.param_dtype
    layers = {}
    d_in = cfg.input_dim
    for i in range(cfg.n_layers):
        layers[f"layer_{i}"] = layer_specs(d_in, H, dt)
        d_in = 2 * H
    return {
        "layers": layers,
        "bottleneck": ParamSpec((2 * H, cfg.lstm_bottleneck), dt, "lecun"),
        "softmax_w": ParamSpec((cfg.lstm_bottleneck, cfg.vocab), dt,
                               "normal", 0.02),
        "softmax_b": ParamSpec((cfg.vocab,), "float32", "zeros"),
    }


def forward(cfg, params, features, lengths=None, *, device=None):
    """features (B, T, input_dim) -> logits (B, T, vocab) f32.

    The BLSTM stack runs layer by layer through the fused bidirectional
    kernel (``kernels.lstm_cell.blstm_layer``), as the reference's
    full-width inference does (``repro/kernels/lstm_cell.py:1199-1204``);
    the bottleneck and softmax are plain matrix products, outside any
    kernel in the reference too.  ``device`` (default: the CUDA card,
    see :func:`repro_torch.device.resolve_device`) must be where
    ``params`` lie; features and lengths are moved there."""
    dev = resolve_device(device)
    x = torch.as_tensor(features, device=dev).to(torch.bfloat16)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    for i in range(cfg.n_layers):
        p = params["layers"][f"layer_{i}"]
        x = blstm_layer(p["fwd"]["wx"], p["fwd"]["wh"], p["fwd"]["b"],
                        p["bwd"]["wx"], p["bwd"]["wh"], p["bwd"]["b"],
                        x, lengths)
    x = torch.matmul(x, params["bottleneck"])
    return torch.matmul(x, params["softmax_w"]).float() + params["softmax_b"]
