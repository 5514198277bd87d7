"""Mixing matrices for decentralized parallel SGD (paper §IV-C, Eq. 14) —
the port of the non-elastic topologies of ``repro.core.mixing``.

One decentralized update is

    W_{k+1} = W_k · T  −  α_k · g(Φ_k, ξ_k)

where the columns of ``W_k`` are per-learner model replicas and ``T`` is
a doubly-stochastic mixing matrix: ``T_1`` (ring) averages each learner
with its two neighbours, ``T_u`` (uniform) is global model averaging, the
allreduce realization of a parameter server (Eq. 13), the hierarchical
ring (paper §V H-ring) is ``kron(T_1(L/p), T_u(p))`` and the exponential
graph [Assran'19] is one-peer gossip with exact consensus every log2(L)
rounds.  The collective forms act on parameter trees stacked over a
leading learner axis; the explicit matrices exist for analysis and
tests.  Means over learners sum in learner order and scale by f32(1/n),
as the reference's ``jnp.mean`` compiles, so the mixers keep its bits.
The elastic matrices are not ported yet (ROADMAP.md queue 1, "Recovery
and elastic training").
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


def identity_matrix(L: int) -> np.ndarray:
    return np.eye(L)


def hierarchical_matrix(L: int, pod_size: int) -> np.ndarray:
    """kron(T_1 over pods, T_u within pod): uniform averaging inside each
    pod of ``pod_size`` learners, ring mixing across the pod means (the
    paper's §V hierarchical ring as one doubly-stochastic matrix)."""
    if L % pod_size:
        raise ValueError(f"pod_size {pod_size} must divide L={L}")
    return np.kron(ring_matrix(L // pod_size), uniform_matrix(pod_size))


def is_doubly_stochastic(T: np.ndarray, atol: float = 1e-6) -> bool:
    return (
        bool(np.all(T >= -atol))
        and np.allclose(T.sum(0), 1.0, atol=atol)
        and np.allclose(T.sum(1), 1.0, atol=atol)
    )


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by IEEE division on every device, as the reference
    divides: PyTorch's CUDA kernel multiplies by an f32 reciprocal when
    the divisor is a Python scalar (up to 1 ulp apart), so the divisor is
    a 0-d tensor on ``x``'s device."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order, the reference's reduction order."""
    total = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        total = total + x.select(dim, i)
    return total


def ordered_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` op for op: the ordered sum scaled by f32(1/n)."""
    scale = torch.tensor(1.0 / x.shape[dim], dtype=torch.float32)
    return ordered_sum(x, dim) * scale


def _ring3(x: torch.Tensor) -> torch.Tensor:
    """T_1 over axis 0 of an f32 tensor (the G == 2 degenerate ring
    included)."""
    if x.shape[0] == 1:
        return x
    if x.shape[0] == 2:
        return div(2.0 * x + torch.roll(x, 1, dims=0), 3.0)
    return div(x + torch.roll(x, 1, dims=0) + torch.roll(x, -1, dims=0), 3.0)


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
            mixed = div(2 * wf + torch.roll(w, 1, dims=0).float(), 3.0)
        else:
            mixed = div(wf + torch.roll(w, 1, dims=0).float()
                        + torch.roll(w, -1, dims=0).float(), 3.0)
        return mixed.to(w.dtype)

    return tree_map(one, params)


def mix_uniform(params):
    """Global model averaging (T_u) — the allreduce PS realization.  The
    f32 sum runs over the learners in order and is scaled by f32(1/L),
    the reference's ``jnp.mean`` op for op."""
    def one(w):
        mean = ordered_mean(w.float(), 0)
        return mean.expand(w.shape).to(w.dtype).contiguous()

    return tree_map(one, params)


def mix_hierarchical(params, *, pod_size: int):
    """Collective form of :func:`hierarchical_matrix`: pod-mean, ring-mix
    the pod means, broadcast back to the pod's members."""
    def one(w):
        L = w.shape[0]
        if L % pod_size:
            raise ValueError(f"pod_size {pod_size} must divide L={L}")
        if pod_size == 1:
            return mix_ring({"w": w})["w"]
        wf = w.float().reshape(L // pod_size, pod_size, -1)
        mixed = _ring3(ordered_mean(wf, 1))
        return mixed[:, None, :].expand(wf.shape).reshape(w.shape).to(
            w.dtype)

    return tree_map(one, params)


def exp_shift(step: int, n_learners: int) -> int:
    """The exponential graph's peer distance at ``step``: 2^(step mod
    log2 L)."""
    return 2 ** (step % max(int(np.log2(n_learners)), 1))


def make_exp_mixer(n_learners: int):
    """One-peer exponential-graph gossip [Assran'19/Ying'21]: at step k each
    learner averages with the peer 2^(k mod log2 L) hops away.

    For L = 2^m this reaches EXACT consensus every m rounds (hypercube
    gossip), at one payload a round.  ``step`` is a host int (the
    reference's ``lax.switch`` over the m shifts becomes indexing)."""
    L = n_learners
    m = max(int(np.log2(L)), 1)
    if 2 ** m != L and L != 1:
        raise ValueError(f"exponential graph wants power-of-2 learners, "
                         f"got {L}")

    def mix(params, step):
        if L == 1:
            return params
        shift = exp_shift(int(step), L)
        return tree_map(lambda w: div(w.float() + torch.roll(
            w.float(), shift, dims=0), 2.0).to(w.dtype), params)

    return mix


def mix_matrix(params, T):
    """General doubly-stochastic mixing (research/analysis path): every
    learner's replica becomes ``sum_l T[m, l] w_l`` in f32."""
    def one(w):
        Tt = torch.as_tensor(np.asarray(T), dtype=torch.float32,
                             device=w.device)
        wf = w.float().reshape(w.shape[0], -1)
        return (Tt @ wf).reshape(w.shape).to(w.dtype)

    return tree_map(one, params)


MIXERS = {
    "ring": mix_ring,
    "uniform": mix_uniform,
    "none": lambda p: p,
}


def get_mixer(kind: str, n_learners: int = 0):
    """Compatibility shim of the reference (for analysis scripts and
    tests): returns ``mixer(params, step) -> params``.  New code builds a
    :class:`repro_torch.core.transport.Transport` instead: 'ring_q8' is
    ``Transport(topology='ring', wire='int8')`` and 'exp' is
    ``Transport(topology='exp')``."""
    if kind == "ring_q8":
        from repro_torch.core.compression import mix_ring_q8
        return lambda p, step=None: mix_ring_q8(p)
    if kind == "exp":
        if not n_learners:
            raise ValueError("exp mixer needs the learner count")
        mixer = make_exp_mixer(n_learners)
        return lambda p, step=None: mixer(p, step)
    f = MIXERS[kind]
    return lambda p, step=None: f(p)
