"""Shared model helpers."""
from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(..., B) int lengths -> (..., B, max_len) bool validity mask, True
    at frames t < lengths[b] (the ``lengths`` batch contract of
    data/pipeline.py)."""
    t = torch.arange(max_len, device=lengths.device)
    return t < lengths[..., None]


def cross_entropy(logits, labels, z_loss: float = 0.0, mask=None, *,
                  per_learner: bool = False):
    """Token-level CE (``repro.models.common.cross_entropy``); logits
    (..., V) any float dtype, labels (...) int.

    The logsumexp is taken in f32.  With ``mask`` (bool, the shape of
    labels) the loss is the sum over valid positions divided by
    max(valid count, 1) — not the padded mean — so padded frames neither
    dilute the loss nor leak into gradients.  ``per_learner=True`` keeps
    the leading (learner) axis: one loss per learner."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    dims = tuple(range(1 if per_learner else 0, loss.dim()))
    if mask is None:
        return loss.mean(dim=dims)
    m = mask.float()
    return (loss * m).sum(dim=dims) / torch.clamp(m.sum(dim=dims), min=1.0)
