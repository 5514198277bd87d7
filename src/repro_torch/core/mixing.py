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

The elastic matrices (the same topologies over a live subset of
learners, for fault-tolerant training) are built from host masks, on the
CPU in f32, in the reference's order of operations; the elastic mixer
copies each step's (L, L) matrix to the card once.
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


# ---------------------------------------------------------------------------
# Elastic matrices: the same topologies over a live subset of learners
# ---------------------------------------------------------------------------
#
# Under elastic membership (learners crash, rejoin, straggle; see
# ``repro_torch.core.faults``) the mixing matrix is rebuilt every step for
# the ACTIVE set: dead learners become identity rows (their replica is
# frozen bit for bit until they rejoin) and the survivors re-form the
# topology among themselves by consecutive rank.  Every input is a host
# mask (activity, delivered edges, staleness counters, the step number),
# so each matrix is a handful of f32 ops on an (L, L) CPU tensor, in the
# reference's order (``jnp.mod`` on integral floats is exact in either
# convention; sums over a row run in index order).  All constructors
# return symmetric doubly-stochastic matrices (the hierarchical one to
# ~1e-6 under ragged pod survivor counts).

_F32 = torch.float32


def _host(x) -> torch.Tensor:
    """A host mask or counter as an f32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", _F32)
    return torch.as_tensor(np.asarray(x), dtype=_F32)


def _with_diag(off: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    return off + torch.diag(diag)


def _elastic_hop_matrix(active, hop, *, exp_weights: bool = False):
    """Gossip at hop ``hop`` over the active learners, by consecutive
    rank: the active learner of rank i exchanges with ranks i ± hop (mod
    the live count).  ``exp_weights=False`` gives ring thirds (the L = 2
    [2/3, 1/3] case included); ``exp_weights=True`` the one-peer
    exponential-graph weights (1/2 self, 1/4 each direction)."""
    a = _host(active)
    L = a.shape[0]
    n = torch.clamp(ordered_sum(a, 0), min=1.0)
    rank = torch.cumsum(a, 0) - 1.0
    d = torch.remainder(rank[:, None] - rank[None, :], n)
    hop = torch.as_tensor(hop, dtype=_F32)
    hit_f = (d == torch.remainder(hop, n)).to(_F32)
    hit_b = (d == torch.remainder(n - hop, n)).to(_F32)
    pair = a[:, None] * a[None, :] * (1.0 - torch.eye(L, dtype=_F32))
    if exp_weights:
        off = pair * 0.25 * (hit_f + hit_b)
    else:
        off = pair * (1.0 / 3.0) * torch.maximum(hit_f, hit_b)
    diag = a * (1.0 - ordered_sum(off, 1)) + (1.0 - a)
    return _with_diag(off, diag)


def elastic_ring_matrix(active):
    """T_1 over the live set: ring thirds among survivors by consecutive
    rank, identity for the dead; all-active is :func:`ring_matrix`."""
    return _elastic_hop_matrix(active, 1.0)


def elastic_exp_matrix(active, step):
    """Time-varying exponential-graph gossip over the live set: at step k
    each survivor exchanges at hop 2^(k mod ceil(log2 n)), both
    directions at 1/4 (symmetrized, so damping and edge drops keep it
    doubly stochastic).  log2 is log(n) / log(2) in f32, as ``jnp.log2``
    lowers."""
    a = _host(active)
    n = torch.clamp(ordered_sum(a, 0), min=1.0)
    log2n = torch.log(n) / torch.log(torch.tensor(2.0, dtype=_F32))
    m = torch.clamp(torch.ceil(log2n), min=1.0)
    k = torch.remainder(torch.tensor(float(step), dtype=_F32), m)
    hop = torch.round(torch.pow(torch.tensor(2.0, dtype=_F32), k))
    return _elastic_hop_matrix(active, hop, exp_weights=True)


def elastic_uniform_matrix(active):
    """T_u over the live set: global averaging among survivors, identity
    for the dead."""
    a = _host(active)
    n = torch.clamp(ordered_sum(a, 0), min=1.0)
    return a[:, None] * a[None, :] / n + torch.diag(1.0 - a)


def elastic_hierarchical_matrix(active, pod_size: int, *,
                                sinkhorn: int = 30):
    """Hierarchical mixing over the live set: uniform averaging among each
    pod's survivors, ring mixing across pods that still have any,
    identity for the dead.  With ragged survivor counts the lifted matrix
    is only row-stochastic, so it is symmetrized and re-balanced by
    ``sinkhorn`` symmetric Sinkhorn sweeps (``rsqrt`` of the row sums);
    with equal survivor counts it is kron(ring, uniform)."""
    a = _host(active)
    L = a.shape[0]
    if L % pod_size:
        raise ValueError(f"pod_size {pod_size} must divide L={L}")
    pods = L // pod_size
    pod_n = ordered_sum(a.reshape(pods, pod_size), 1)
    pod_alive = (pod_n > 0).to(_F32)
    Tp = _elastic_hop_matrix(pod_alive, 1.0)
    share = a / torch.clamp(torch.repeat_interleave(pod_n, pod_size),
                            min=1.0)
    lift = torch.repeat_interleave(
        torch.repeat_interleave(Tp, pod_size, 0), pod_size, 1)
    R = a[:, None] * lift * share[None, :] + torch.diag(1.0 - a)
    S = 0.5 * (R + R.T)
    for _ in range(sinkhorn):
        inv = torch.rsqrt(torch.clamp(ordered_sum(S, 1), min=1e-12))
        S = S * inv[:, None] * inv[None, :]
    return S


def _rebalanced(off: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal of ``off`` and return the freed row mass to it."""
    off = off - torch.diag(torch.diagonal(off))
    return _with_diag(off, 1.0 - ordered_sum(off, 1))


def staleness_damped(T, staleness, lam):
    """Down-weight stale learners' cross influence: confidence c_i = 1 /
    (1 + λ·s_i), off-diagonals T_ij·c_i·c_j, the freed mass back on the
    diagonal (symmetric, so doubly stochastic; λ = 0 is the identity)."""
    T = _host(T)
    c = 1.0 / (1.0 + lam * _host(staleness))
    return _rebalanced(T * c[:, None] * c[None, :])


def edge_masked(T, edge_ok):
    """Drop gossip edges: zero the masked off-diagonal entries (the mask
    is symmetric) and return the freed mass to the diagonal."""
    return _rebalanced(_host(T) * _host(edge_ok))


def elastic_matrix(active, topology: str, *, step=0, pod_size: int = 1,
                   staleness=None, staleness_lambda: float = 0.0,
                   edge_ok=None):
    """One elastic mixing matrix, an f32 (L, L) CPU tensor: ``topology``
    over the live set, then dropped-edge masking, then staleness
    damping."""
    if topology == "none":
        T = torch.eye(_host(active).shape[0], dtype=_F32)
    elif topology == "ring":
        T = elastic_ring_matrix(active)
    elif topology == "uniform":
        T = elastic_uniform_matrix(active)
    elif topology == "exp":
        T = elastic_exp_matrix(active, step)
    elif topology == "hierarchical":
        T = elastic_hierarchical_matrix(active, pod_size)
    else:
        raise ValueError(f"unknown topology {topology!r} for elastic "
                         f"mixing")
    if edge_ok is not None:
        T = edge_masked(T, edge_ok)
    if staleness is not None and staleness_lambda > 0.0:
        T = staleness_damped(T, staleness, staleness_lambda)
    return T


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
