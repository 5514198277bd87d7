"""Shared model helpers: norms, RoPE and sinusoidal positions,
activations, masks and the loss — the port of ``repro.models.common`` —
and the products of learner-stacked weights (:func:`linear`,
:func:`per_learner`) through which the training forward runs every
learner in one pass."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collective
from repro_torch.params import ParamSpec


# ---------------------------------------------------------------------------
# Learner-stacked weights
# ---------------------------------------------------------------------------

def linear(x, w):
    """x (..., K) @ w (K, N); or, for a learner-stacked weight w (L, K,
    N) and x (L, ..., K), one batched product over each learner's rows
    (the lstm model's ``_rows``)."""
    if w.dim() == 2:
        return x @ w
    L, K, N = w.shape
    return torch.bmm(x.reshape(L, -1, K), w).reshape(*x.shape[:-1], N)


def per_learner(w, nd: int, ndim: int):
    """A parameter of ``nd`` dims of its own, or with a leading learner
    axis on top of them, made broadcastable against a tensor of ``ndim``
    dims (whose first axis is the learner's when ``w`` has one)."""
    if w.dim() == nd:
        return w
    return w.reshape((w.shape[0],) + (1,) * (ndim - 1 - nd)
                     + tuple(w.shape[1:]))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(cfg, dim=None, axes=("embed",)) -> dict:
    """f32 scale (ones), plus a zero bias for LayerNorm."""
    dim = dim if dim is not None else cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((dim,), "float32", "ones", axes=axes),
                "bias": ParamSpec((dim,), "float32", "zeros", axes=axes)}
    return {"scale": ParamSpec((dim,), "float32", "ones", axes=axes)}


def apply_norm(p, x, eps: float = 1e-5):
    """RMSNorm, or LayerNorm when ``p`` has a bias; f32 inside, the input
    dtype out."""
    xf = x.float()
    scale = per_learner(p["scale"], 1, x.dim())
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = ((xf - mu) * torch.rsqrt(var + eps) * scale
             + per_learner(p["bias"], 1, x.dim()))
    else:
        ms = torch.square(xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale
    return y.to(x.dtype)


def rmsnorm(x, scale=None, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(torch.square(xf).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * per_learner(scale, 1, x.dim())
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary and sinusoidal positions, activations
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_angles(positions, head_dim: int, theta: float):
    """(sin, cos) of the rotary angles for ``positions`` (..., S), each
    (..., S, 1, E/2) f32.  A forward computes them once and every layer
    rotates its q and k with them."""
    # rope_freqs in torch ops on the positions' device: no host-to-device
    # copy (which would synchronise the stream) on the decode path
    ar = torch.arange(0, head_dim, 2, dtype=torch.float64,
                      device=positions.device)
    freqs = (1.0 / (theta ** (ar / head_dim))).float()
    ang = (positions[..., None].float() * freqs)[..., None, :]
    return torch.sin(ang), torch.cos(ang)


def rotate(x, sin, cos):
    """Rotate the two halves of E (the reference's non-interleaved
    layout) of x (..., S, H, E) in f32; x's dtype out."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x (..., S, H, E); positions broadcastable to (..., S)."""
    if theta <= 0:
        return x
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def sinusoidal_positions(positions, d_model: int):
    """Whisper-style fixed sinusoidal embeddings of ``positions`` (..., S)
    -> (..., S, d_model) f32: [sin, cos] of positions x exp(-ln(10^4) i /
    (d/2 - 1)), computed in f32 as the reference computes them (its
    callers cast to the activations' dtype), on the positions' device."""
    half = d_model // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    c = torch.tensor(-np.log(10_000.0), dtype=torch.float32,
                     device=positions.device)
    freqs = torch.exp(c * i / float(max(half - 1, 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(..., B) int lengths -> (..., B, max_len) bool validity mask, True
    at frames t < lengths[b] (the ``lengths`` batch contract of
    data/pipeline.py)."""
    t = torch.arange(max_len, device=lengths.device)
    return t < lengths[..., None]


class _ValueOf(torch.autograd.Function):
    """``value``'s bits forward, ``x``'s gradient backward."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def cross_entropy(logits, labels, z_loss: float = 0.0, mask=None, *,
                  per_learner: bool = False, denominator=None):
    """Token-level CE (``repro.models.common.cross_entropy``); logits
    (..., V) any float dtype, labels (...) int.

    The logsumexp is taken in f32.  With ``mask`` (bool, the shape of
    labels) the loss is the sum over valid positions divided by
    max(valid count, 1) — not the padded mean — so padded frames neither
    dilute the loss nor leak into gradients.  ``per_learner=True`` keeps
    the leading (learner) axis: one loss per learner.  ``denominator``
    replaces the count of positions: the loss is then this batch's term
    of a mean over a larger one (a rank's rows of the global batch)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    dims = tuple(range(1 if per_learner else 0, loss.dim()))

    def reduce(x, op):
        r = getattr(x, op)(dim=dims)
        if not (per_learner and x.is_cuda and collective.world()[1] > 1):
            return r
        # a rank's block of learners on the card: CUDA sizes a reduction's
        # blocks by its count of outputs, so the block's losses take their
        # values from the gathered stack's reduction (one process's bits)
        # and their gradient from the block's own
        whole = getattr(collective.gather_learners(x.detach()), op)(dim=dims)
        return _ValueOf.apply(r, collective.block_rows(whole))

    if mask is not None:
        loss = loss * mask.float()
    if denominator is not None:
        return loss.sum(dim=dims) / denominator
    if mask is None:
        return reduce(loss, "mean")
    return reduce(loss, "sum") / torch.clamp(mask.float().sum(dim=dims),
                                             min=1.0)
