"""Recognition-quality metrics (the paper reports WER on Hub5'00; with
synthetic data the analogues are frame error rate for the CE-trained
DNN-HMM and token error rate — the same Levenshtein WER formula over
synthetic token sequences — for CTC/seq2seq models).

All metrics honor the variable-length ``lengths`` batch contract of
``repro.data.pipeline``: frames at ``t >= lengths[b]`` are padding and
are excluded from FER and from the decoded token streams.  Beam decoding
lives in ``repro.decode`` (``beam_decode`` is the drop-in beam
counterpart of :func:`greedy_ctc_decode`).
"""
from __future__ import annotations

import numpy as np


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two sequences (the WER numerator).

    Row-sweep DP: each reference row is one vectorized numpy pass — the
    sequential insertion chain ``dp[j] = min(cand[j], dp[j-1] + 1)``
    unrolls to ``min_{i<=j} cand[i] + (j - i)``, i.e. a running minimum
    of ``cand - j`` (``np.minimum.accumulate``) plus ``j``.  Exact
    parity with the per-cell loop is locked by a test."""
    ref, hyp = np.asarray(list(ref)), np.asarray(list(hyp))
    m, n = len(ref), len(hyp)
    if m == 0 or n == 0:
        return int(m or n)
    dp = np.arange(n + 1)
    j = np.arange(n + 1)
    cand = np.empty(n + 1, dp.dtype)
    for i in range(1, m + 1):
        cand[0] = i
        np.minimum(dp[:-1] + (ref[i - 1] != hyp),    # substitution
                   dp[1:] + 1,                       # deletion
                   out=cand[1:])
        dp = np.minimum.accumulate(cand - j) + j     # insertion chain
    return int(dp[n])


def token_error_rate(refs, hyps) -> float:
    """sum(edit distances) / sum(ref lengths) — i.e. WER over tokens."""
    num = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    den = sum(max(len(r), 1) for r in refs)
    return num / den


def frame_error_rate(logits, labels, lengths=None) -> float:
    """Framewise classification error of the DNN-HMM (CE-trained) model.
    logits: (B,T,V) array-like; labels: (B,T); ``lengths`` (B,) excludes
    padded frames (t >= lengths[b]) from both numerator and denominator
    per the ``data/pipeline.py`` batch contract."""
    pred = np.asarray(logits).argmax(-1)
    labels = np.asarray(labels)
    err = pred != labels
    if lengths is None:
        return float(err.mean())
    T = labels.shape[1]
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return float(err[mask].sum() / max(mask.sum(), 1))


def greedy_ctc_decode(logits, lengths=None, *, blank: int = 0):
    """Best-path CTC decoding: argmax per frame, merge repeats, drop
    blanks.  logits: (B,T,V); ``lengths`` (B,) truncates each row to its
    valid frames.  Returns list of int lists."""
    pred = np.asarray(logits).argmax(-1)
    out = []
    for i, row in enumerate(pred):
        if lengths is not None:
            row = row[:int(lengths[i])]
        seq, prev = [], None
        for c in row:
            c = int(c)
            if c != prev and c != blank:
                seq.append(c)
            prev = c
        out.append(seq)
    return out


def collapse_labels(labels, lengths=None, *, blank: int = 0):
    """Frame labels -> reference token sequences for TER: merge repeats,
    drop the ``blank`` class, truncate to ``lengths``.  The evaluation
    convention (docs/decoding.md): class 0 — the most frequent CD state
    under the Zipf priors of the synthetic data — plays the
    blank/silence role on both the reference and hypothesis side, so
    TER is meaningful for CE- and CTC-trained checkpoints alike."""
    labels = np.asarray(labels)
    out = []
    for i, row in enumerate(labels):
        n = int(lengths[i]) if lengths is not None else len(row)
        row = row[:n]
        if n == 0:
            out.append([])
            continue
        keep = np.ones(n, bool)
        keep[1:] = row[1:] != row[:-1]
        out.append([int(c) for c in row[keep] if c != blank])
    return out
