"""Exact numpy oracle for the vectorized prefix beam search.

Dict-of-real-prefixes reference (no fixed beam slots, no rolling hash):
the classic Hannun et al. 2014 algorithm written for clarity, against
which ``decode/beam.py`` and the Pallas kernel are allclose/bit-equal in
tests (ties excepted — the vectorized impl breaks score ties by
candidate index, the oracle by dict/sort order, so parity tests use
continuous random logits where ties have measure zero).
"""
from __future__ import annotations

import numpy as np

NEG = -1e30


def _merge(semiring):
    if semiring == "max":
        return max
    if semiring == "sum":
        return np.logaddexp
    raise ValueError(f"semiring must be 'max' or 'sum', got {semiring!r}")


def _log_softmax(x):
    x = np.asarray(x, np.float32)
    m = x.max(-1, keepdims=True)
    e = np.exp(x - m)
    return x - m - np.log(e.sum(-1, keepdims=True))


def prefix_beam_ref(logits, lengths=None, *, beam: int = 8, blank: int = 0,
                    semiring: str = "max", len_norm: float = 0.0,
                    max_len: int = None):
    """(B, T, V) logits -> (hyps: list of int lists, scores: list of
    float).  Same contract as ``beam.beam_search`` (U cap, lengths
    freeze, length-normalized final ranking)."""
    logp = _log_softmax(logits)
    B, T, V = logp.shape
    U = max_len if max_len is not None else T
    merge = _merge(semiring)
    hyps, scores = [], []
    for b in range(B):
        Tb = int(lengths[b]) if lengths is not None else T
        beams = {(): (0.0, NEG)}                      # prefix -> (p_b, p_nb)
        for t in range(min(Tb, T)):
            lp = logp[b, t]
            new = {}

            def bump(prefix, i, val):
                e = new.setdefault(prefix, [NEG, NEG])
                e[i] = float(merge(e[i], val))

            for prefix, (pb, pnb) in beams.items():
                tot = float(merge(pb, pnb))
                bump(prefix, 0, tot + lp[blank])
                if prefix:
                    bump(prefix, 1, pnb + lp[prefix[-1]])
                if len(prefix) < U:
                    for c in range(V):
                        if c == blank:
                            continue
                        base = pb if (prefix and c == prefix[-1]) else tot
                        bump(prefix + (c,), 1, base + lp[c])
            ranked = sorted(new.items(),
                            key=lambda kv: -float(merge(*kv[1])))
            beams = {p: tuple(s) for p, s in ranked[:beam]}

        def final_score(prefix, pb, pnb):
            tot = float(merge(pb, pnb))
            if len_norm:
                tot = tot / max(len(prefix), 1) ** len_norm
            return tot

        best, (pb, pnb) = max(beams.items(),
                              key=lambda kv: final_score(kv[0], *kv[1]))
        hyps.append(list(best))
        scores.append(final_score(best, pb, pnb))
    return hyps, scores
