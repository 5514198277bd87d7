"""Shared model helpers."""
from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool validity mask, True at frames
    t < lengths[b] (the ``lengths`` batch contract of data/pipeline.py)."""
    t = torch.arange(max_len, device=lengths.device)
    return t[None, :] < lengths[:, None]
