"""Mixing matrices for decentralized parallel SGD (paper §IV-C, Eq. 14) —
the port of the static topologies of ``repro.core.mixing``.

One decentralized update is

    W_{k+1} = W_k · T  −  α_k · g(Φ_k, ξ_k)

where the columns of ``W_k`` are per-learner model replicas and ``T`` is
a doubly-stochastic mixing matrix: ``T_1`` (ring) averages each learner
with its two neighbours, ``T_u`` (uniform) is global model averaging, the
allreduce realization of a parameter server (Eq. 13).  The collective
forms act on parameter trees stacked over a leading learner axis; the
explicit matrices exist for analysis and tests.  The hierarchical and
exponential topologies and the elastic matrices are not ported yet
(ROADMAP.md queue 1, "Topologies and strategies not yet ported" and
"Recovery and elastic training").
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map


def ring_matrix(L: int) -> np.ndarray:
    """T_1: tridiagonal-with-wraparound, 1/3 each (paper's example)."""
    if L == 1:
        return np.ones((1, 1))
    if L == 2:
        # degenerate ring: self + the single neighbor (counted twice in the
        # tridiagonal pattern) -> [2/3, 1/3]
        return np.array([[2 / 3, 1 / 3], [1 / 3, 2 / 3]])
    T = np.zeros((L, L))
    for i in range(L):
        T[i, i] = 1 / 3
        T[i, (i - 1) % L] = 1 / 3
        T[i, (i + 1) % L] = 1 / 3
    return T


def uniform_matrix(L: int) -> np.ndarray:
    """T_u: global model averaging."""
    return np.full((L, L), 1.0 / L)


def is_doubly_stochastic(T: np.ndarray, atol: float = 1e-6) -> bool:
    return (
        bool(np.all(T >= -atol))
        and np.allclose(T.sum(0), 1.0, atol=atol)
        and np.allclose(T.sum(1), 1.0, atol=atol)
    )


def mix_ring(params):
    """(w[l-1] + w[l] + w[l+1]) / 3 along the stacked learner axis 0.

    The neighbours are rolled in their own (usually bf16) dtype, as the
    reference rolls before it upcasts (the payload its collective-permute
    moves), then the average is taken in f32 and cast back."""
    def one(w):
        if w.shape[0] == 1:
            return w
        wf = w.float()
        if w.shape[0] == 2:
            mixed = (2 * wf + torch.roll(w, 1, dims=0).float()) / 3.0
        else:
            mixed = (wf + torch.roll(w, 1, dims=0).float()
                     + torch.roll(w, -1, dims=0).float()) / 3.0
        return mixed.to(w.dtype)

    return tree_map(one, params)


def mix_uniform(params):
    """Global model averaging (T_u) — the allreduce PS realization.  The
    f32 sum runs over the learners in order and is scaled by f32(1/L),
    the reference's ``jnp.mean`` op for op."""
    def one(w):
        total = w[0].float()
        for i in range(1, w.shape[0]):
            total = total + w[i].float()
        mean = total * torch.tensor(1.0 / w.shape[0], dtype=torch.float32)
        return mean.expand(w.shape).to(w.dtype).contiguous()

    return tree_map(one, params)
