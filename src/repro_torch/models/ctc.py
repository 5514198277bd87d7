"""CTC loss (Graves et al. 2006) — the port of ``repro.models.ctc``: the
paper's §III names CTC as the end-to-end ASR criterion beside frame CE.

The alpha (forward) recursion over the blank-extended label sequence runs
in log space as a T-step loop of torch ops, differentiable by autograd.
Per-sequence label lengths (labels padded with -1) and input lengths
(right-padded frames, the ``lengths`` batch contract of
``data/pipeline.py``) follow the reference: alpha freezes beyond a
sequence's last valid frame, which is exactly the NLL of the unpadded
sequence.  A class index >= V (out of the vocabulary) emits NaN, as the
reference's ``take_along_axis`` fills it, so the loss is NaN rather than
an error.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import sequence_mask

NEG = -1e30


def _logsumexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m = torch.clamp(m, min=NEG)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _shift(alpha, k: int):
    """alpha shifted right by k states along S, NEG entering."""
    pad = torch.full((alpha.shape[0], k), NEG, dtype=alpha.dtype,
                     device=alpha.device)
    return torch.cat([pad, alpha[:, :alpha.shape[1] - k]], dim=1)


def _ctc_nll(logits, labels, label_lengths, blank: int, input_lengths):
    """(B, T, V) logits -> (B,) negative log likelihoods."""
    B, T, V = logits.shape
    dev = logits.device
    labels = torch.as_tensor(labels, device=dev).long()
    U = labels.shape[1]
    if label_lengths is None:
        label_lengths = (labels >= 0).sum(dim=1)
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()
    labels = labels.clamp(min=0)
    frame_ok = (None if input_lengths is None else sequence_mask(
        torch.as_tensor(input_lengths, device=dev), T))       # (B, T)

    # f32 as in the reference; f64 logits stay f64 (an oracle's precision)
    dt = torch.float64 if logits.dtype == torch.float64 else torch.float32
    logp = torch.log_softmax(logits.to(dt), dim=-1)

    # blank-extended sequence z: (B, S=2U+1): [b, l1, b, l2, ..., lU, b]
    S = 2 * U + 1
    z = torch.full((B, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels
    s_idx = torch.arange(S, device=dev)
    valid = s_idx[None, :] < (2 * label_lengths + 1)[:, None]    # (B, S)
    # skip-transition allowed where z_s is a label and != z_{s-2}
    z_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                 device=dev), z[:, :S - 2]], dim=1)
    can_skip = (s_idx[None, :] % 2 == 1) & (z != z_m2)
    # every frame's emissions at once; an out-of-vocabulary class emits
    # NaN (the reference's gather fills it)
    emit = torch.gather(logp, 2, z.clamp(max=V - 1)[:, None, :].expand(
        B, T, S))
    emit = torch.where((z < V)[:, None, :], emit, float("nan"))

    first = torch.where(label_lengths > 0, emit[:, 0, 1], NEG)
    alpha = torch.cat([logp[:, 0, blank, None], first[:, None],
                       torch.full((B, S - 2), NEG, dtype=dt, device=dev)],
                      dim=1)
    for t in range(1, T):
        prev2 = torch.where(can_skip, _shift(alpha, 2), NEG)
        new = _logsumexp3(alpha, _shift(alpha, 1), prev2) + emit[:, t]
        new = torch.where(valid, new, NEG)
        if frame_ok is not None:
            # padded frame: freeze alpha, so the final read equals the
            # recursion stopped at the row's last valid frame
            new = torch.where(frame_ok[:, t, None], new, alpha)
        alpha = new

    last = 2 * label_lengths            # index of the final blank
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG)
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


def ctc_loss(logits, labels, label_lengths=None, *, blank: int = 0,
             input_lengths=None):
    """logits (B, T, V); labels (B, U) int (pad with -1 beyond length);
    label_lengths (B,) (default: count of non-negative labels);
    input_lengths (B,) valid frame count per row (default: all T frames).
    Returns the mean negative log likelihood over the batch, in f32 (in
    f64 for f64 logits).

    Over stacked learners (logits (L, B/L, T, V), labels (L, B/L, U),
    lengths (L, B/L)) it returns the (L,) per-learner means, as the
    reference's loss under ``jax.vmap`` does."""
    if logits.dim() == 3:
        return _ctc_nll(logits, labels, label_lengths, blank,
                        input_lengths).mean()
    L, B = logits.shape[:2]

    def flat(x):
        return None if x is None else torch.as_tensor(x).reshape(
            (L * B,) + tuple(x.shape[2:]))
    nll = _ctc_nll(logits.reshape((L * B,) + tuple(logits.shape[2:])),
                   flat(labels), flat(label_lengths), blank,
                   flat(input_lengths))
    return nll.reshape(L, B).mean(dim=1)


def collapse_frame_labels(frame_labels, max_len: int, *, blank: int = 0):
    """Frame-wise targets -> collapsed CTC label sequences (numpy, host
    side): remove repeats, shift classes by +1 (0 reserved for blank),
    pad with -1."""
    B, T = frame_labels.shape
    out = np.full((B, max_len), -1, np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        prev, j = None, 0
        for t in range(T):
            c = int(frame_labels[b, t])
            if c != prev and j < max_len:
                out[b, j] = c + 1
                j += 1
            prev = c
        lens[b] = j
    return out, lens
