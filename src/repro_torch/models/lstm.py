"""The paper's acoustic model: 6-layer bi-directional LSTM with a linear
bottleneck and a 32,000-way CD-HMM-state softmax (Cui et al. §V) — the
port of ``repro.models.lstm`` (forward and training loss).

Variable-length utterances follow the reference's ``lengths`` contract:
on padded steps (t >= lengths[b]) the (h, c) carry is frozen and the
layer output is 0, so the reverse direction reverses within each
utterance's valid span.
"""
from __future__ import annotations

import torch

from repro_torch.device import plain_path, resolve_device
from repro_torch.kernels.lstm_cell import (blstm_sequence, blstm_stack,
                                           lstm_sequence)
from repro_torch.kernels.ref import blstm_stack_plain
from repro_torch.models.common import cross_entropy, sequence_mask
from repro_torch.params import ParamSpec


def lstm_cell_step(wx, wh, b, x_t, h, c):
    """One LSTM step in x's dtype (``repro.models.lstm.lstm_cell_step``):
    x_t (B, D_in), h (B, H) in x's dtype, c (B, H) f32; gate order
    i|f|g|o, forget bias +1."""
    gates = (x_t @ wx + h @ wh).float() + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(x_t.dtype), c


def _lstm_layer_plain(p, x, lengths, reverse):
    """The reference's jnp ``lstm_layer`` (a scan of
    :func:`lstm_cell_step`) in torch ops, differentiable by autograd."""
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    h = x.new_zeros(B, H)
    c = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h2, c2 = lstm_cell_step(p["wx"], p["wh"], p["b"], x[:, t], h, c)
        if lengths is None:
            h, c, out[t] = h2, c2, h2
            continue
        v = (t < lengths)[:, None]
        h = torch.where(v, h2, h)                   # freeze the carry
        c = torch.where(v, c2, c)
        out[t] = torch.where(v, h2, torch.zeros_like(h2))
    return torch.stack(out, dim=1)


def lstm_layer(p, x, *, lengths=None, reverse: bool = False,
               stash_dtype: str = None, seq_chunk: int = 0):
    """One direction, x (B, T, D_in) -> (B, T, H)
    (``repro.models.lstm.lstm_layer``).  On the kernel path
    :func:`~repro_torch.kernels.lstm_cell.lstm_sequence` (K1; under a
    gradient K1-stash + K2, or with ``seq_chunk`` K1-chunk + K3, the stash
    in ``stash_dtype``); on the plain path the reference's jnp scan in x's
    dtype.  ``lengths`` (B,) masks as the module docstring says."""
    if plain_path(x):
        return _lstm_layer_plain(p, x, lengths, reverse)
    return lstm_sequence(p["wx"], p["wh"], p["b"], x, lengths,
                         reverse=reverse, stash_dtype=stash_dtype,
                         seq_chunk=seq_chunk)


def layer_specs(d_in: int, hidden: int, dtype: str) -> dict:
    def direction():
        return {
            "wx": ParamSpec((d_in, 4 * hidden), dtype, "lecun",
                            axes=("feature", "lstm_gates")),
            "wh": ParamSpec((hidden, 4 * hidden), dtype, "lecun",
                            axes=("lstm_hidden", "lstm_gates")),
            "b": ParamSpec((4 * hidden,), "float32", "zeros",
                           axes=("lstm_gates",)),
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
        "bottleneck": ParamSpec((2 * H, cfg.lstm_bottleneck), dt, "lecun",
                                axes=("lstm_hidden", "bottleneck")),
        "softmax_w": ParamSpec((cfg.lstm_bottleneck, cfg.vocab), dt,
                               "normal", 0.02, ("bottleneck", "vocab")),
        "softmax_b": ParamSpec((cfg.vocab,), "float32", "zeros",
                               axes=("vocab",)),
    }


def _layer_weights(p):
    return (p["fwd"]["wx"], p["fwd"]["wh"], p["fwd"]["b"],
            p["bwd"]["wx"], p["bwd"]["wh"], p["bwd"]["b"])


def _rows(x, w):
    """x (..., K) @ w (K, N), or per learner x (L, B, T, K) @ w (L, K, N):
    one batched product over each learner's B*T rows."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    L, B, T, K = x.shape
    return torch.bmm(x.reshape(L, B * T, K), w).reshape(L, B, T, -1)


def forward(cfg, params, features, lengths=None, *, device=None,
            plain=False):
    """features (B, T, input_dim) -> logits (B, T, vocab) f32; or, over
    stacked learners, params with a leading (L,) axis on every leaf and
    features (L, B/L, T, input_dim) -> (L, B/L, T, vocab).

    Without a gradient the whole BLSTM stack is one launch of the fused
    stack kernel K4 (:func:`~repro_torch.kernels.lstm_cell.blstm_stack`),
    as the reference's ``forward`` runs ``blstm_stack``
    (``repro/models/lstm.py:155-164``), bit-identical to the per-layer
    inference loop.  When a weight requires a gradient it runs layer by
    layer through the differentiable
    :func:`~repro_torch.kernels.lstm_cell.blstm_sequence` (K1's stashing
    variant and K2, or with ``cfg.lstm_seq_chunk`` K1-chunk and K3,
    honouring ``cfg.lstm_stash_dtype``), as the reference's custom VJP
    does (``repro/kernels/lstm_cell.py:1268-1303``).  The bottleneck and
    softmax are plain matrix products, outside any kernel in the
    reference too.  ``device`` (default: the CUDA card, see
    :func:`repro_torch.device.resolve_device`) must be where ``params``
    lie; features and lengths are moved there.  ``plain=True`` runs the
    plain PyTorch layers on any device (the oracle)."""
    dev = resolve_device(device)
    x = torch.as_tensor(features, device=dev).to(torch.bfloat16)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    layers = [_layer_weights(params["layers"][f"layer_{i}"])
              for i in range(cfg.n_layers)]
    if torch.is_grad_enabled() and any(w.requires_grad for ws in layers
                                       for w in ws):
        one = x.dim() == 3                  # one model: a learner axis of 1
        if one:
            x = x.unsqueeze(0)
            lengths = None if lengths is None else lengths.unsqueeze(0)
        for ws in layers:
            x = blstm_sequence(
                *(w.unsqueeze(0) if one else w for w in ws), x, lengths,
                stash_dtype=cfg.lstm_stash_dtype,
                seq_chunk=cfg.lstm_seq_chunk, plain=plain)
        x = x.squeeze(0) if one else x
    elif plain:
        x = blstm_stack_plain(layers, x, lengths)
    else:
        x = blstm_stack(layers, x, lengths)
    x = _rows(x, params["bottleneck"])
    b = params["softmax_b"]
    if b.dim() == 2:                        # (L, V) against (L, B, T, V)
        b = b[:, None, None]
    return _rows(x, params["softmax_w"]).float() + b


def loss_train(cfg, params, batch, *, device=None, plain=False,
               denominator=None):
    """Frame-level CE (``repro.models.lstm.loss_train``).  If the batch
    carries ``lengths``, padded frames are excluded and the loss
    normalises by the valid-frame count (by ``denominator`` where one is
    given: see ``cross_entropy``).  Over stacked learners (features
    (L, B/L, T, D)) it returns the (L,) per-learner losses."""
    lengths = batch.get("lengths")
    logits = forward(cfg, params, batch["features"], lengths,
                     device=device, plain=plain)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = (None if lengths is None else sequence_mask(
        torch.as_tensor(lengths, device=logits.device), logits.shape[-2]))
    return cross_entropy(logits, labels, mask=mask,
                         per_learner=logits.dim() == 4,
                         denominator=denominator)
