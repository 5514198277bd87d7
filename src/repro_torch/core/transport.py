"""Communication substrate: topology × wire × bucketing (paper §IV-D) —
the port of the non-elastic ``repro.core.transport.Transport``.

The paper's thesis is that distributed ASR training is won by "striking
the balance between communication and computation".  A
:class:`Transport` names who exchanges with whom (``topology``) and the
codec of what crosses the wire (``wire``); every mixing site of the
strategies goes through it.  On one card the learners are one stacked
axis, so a mixing round is a tensor op over that axis.

* ``topology`` — doubly-stochastic mixing over the learner axis (Eq. 14):
  ``uniform`` (T_u, the allreduce realization of a parameter server),
  ``ring`` (T_1), ``hierarchical`` (T_u inside pods of ``pod_size``, T_1
  across the pod means: the paper's §V H-ring), ``exp`` (one-peer
  exponential graph, exact consensus every log2(L) rounds) and ``none``.
* ``wire`` — the codec of every payload a peer receives: ``f32`` (exact),
  ``bf16`` (2 B/elem), ``int8`` (1 B/elem, one f32 scale per sender per
  bucket) and ``topk`` (the largest ``topk_frac`` entries, 8 B each, with
  CHOCO difference coding against a shared estimate and the
  error-feedback residual kept in ``state['comm']``, f32 whatever the
  parameter dtype; mixing becomes the γ-damped gossip
  ``w += γ·(T·ŵ − ŵ)``, which preserves the replica mean).  On the flat
  topologies the local replica stays exact; the hierarchical intra-pod
  stage models an allreduce, so its pod mean is over coded payloads, own
  included, coded by ``intra_wire`` (never ``topk``).
* ``bucket_bytes`` — payloads are split into column buckets of at most
  that many f32 bytes, each coded on its own (per-bucket scales and
  top-k); 0 = one payload per tensor.

Everything is elementwise IEEE arithmetic in the reference's order (the
means over learners and pods sum in index order and scale by f32(1/n),
as ``jnp.mean`` compiles), so the mixed replicas and the EF state keep
the reference's bits.  ``wire_bytes`` is the analytic bytes each learner
sends per round.  :meth:`Transport.make_elastic_mixer` mixes over a live
subset of learners (fault-tolerant training) through one doubly-stochastic
matrix a step, built on the host and applied as a full-f32 (L, L) × (L, n)
product per leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.optim.optimizers import tree_map

TOPOLOGIES = ("none", "uniform", "ring", "hierarchical", "exp")
WIRES = ("f32", "bf16", "int8", "topk")

# wires that carry an error-feedback residual in strategy state
_EF_WIRES = ("topk",)


def _needs_ef(wire: str) -> bool:
    return wire in _EF_WIRES


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# Wire codecs (per sender; act on (G, n) f32 payload buckets)
# ---------------------------------------------------------------------------

def decode_payload(wire: str, x: torch.Tensor, topk_frac: float = 0.01):
    """What the receivers see of the (G, n) f32 payload ``x``: each of the
    G senders' rows is coded independently (per-sender scales/top-k)."""
    if wire == "f32":
        return x
    if wire == "bf16":
        return x.to(torch.bfloat16).float()
    if wire == "int8":
        amax = x.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, mixing.div(amax, 127.0),
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    if wire == "topk":
        n = x.shape[1]
        k = _topk_k(n, topk_frac)
        if k >= n:
            return x
        mag = x.abs()
        kth = torch.topk(mag, k, dim=1).values[:, -1:]
        # >= keeps ties (may ship slightly more than k on degenerate
        # inputs); the wire accounting uses the nominal k
        return torch.where(mag >= kth, x, torch.zeros((), device=x.device))
    raise ValueError(f"unknown wire {wire!r}; expected one of {WIRES}")


def _topk_k(n: int, frac: float) -> int:
    return min(n, max(1, int(np.ceil(frac * n))))


def _ring_sends(G: int) -> float:
    """Payloads each member sends per T_1 round: both neighbors (2), the
    single neighbor when G==2, nothing when alone."""
    return 0.0 if G <= 1 else (1.0 if G == 2 else 2.0)


# ---------------------------------------------------------------------------
# Topology combines: local replica w (full precision) + decoded peers d
# ---------------------------------------------------------------------------

def _combine_ring(w, d):
    G = w.shape[0]
    if G == 1:
        return w
    if G == 2:
        return mixing.div(2.0 * w + torch.roll(d, 1, dims=0), 3.0)
    return mixing.div(w + torch.roll(d, 1, dims=0) + torch.roll(d, -1, dims=0),
                      3.0)


def _combine_uniform(w, d):
    G = w.shape[0]
    if G == 1:
        return w
    # own contribution stays exact; peers' arrive decoded
    return mixing.div(w - d + mixing.ordered_sum(d, 0)[None], G)


def _combine_exp(w, d, step: int, G: int):
    if G == 1:
        return w
    return mixing.div(w + torch.roll(d, mixing.exp_shift(step, G), dims=0),
                      2.0)


def noise_seed(fault_seed: int, step: int, leaf: int, row: int) -> int:
    """The seed of one corruption draw: learner ``row``'s payload of leaf
    ``leaf`` (in the params' key order) at ``step`` under ``fault_seed``,
    a function of those four numbers alone."""
    ss = np.random.SeedSequence([int(fault_seed) % 2 ** 63, int(step),
                                 int(leaf), int(row)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _require_full_f32(device):
    """The elastic product is held to f32 (a TF32 product moves each mix
    by ~1e-3): refuse to run it on a card set to TF32."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "elastic mixing needs full-f32 matrix products: "
            "torch.backends.cuda.matmul.allow_tf32 is on or the f32 matmul "
            "precision is not 'highest'")


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Transport:
    """One composable communication configuration (see module docstring)."""

    topology: str = "ring"
    wire: str = "f32"
    # hierarchical only: codec of the intra-pod averaging stage (the
    # inter-pod ring uses ``wire``), e.g. bf16 intra-pod + topk inter-pod
    intra_wire: str = "f32"
    bucket_bytes: int = 0        # 0 = one fused payload per tensor
    pod_size: int = 1            # hierarchical: learners per pod
    topk_frac: float = 0.01      # topk wire: fraction of entries shipped
    # consensus step of the difference-coded (topk) gossip; 0 = auto,
    # min(0.5, topk_frac)
    gossip_gamma: float = 0.0
    # elastic mixing only: a learner s steps behind mixes with confidence
    # 1/(1 + λ·s)
    staleness_lambda: float = 0.0

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"expected one of {TOPOLOGIES}")
        for w in (self.wire, self.intra_wire):
            if w not in WIRES:
                raise ValueError(f"unknown wire {w!r}; "
                                 f"expected one of {WIRES}")
        if self.intra_wire in _EF_WIRES:
            raise ValueError(
                f"intra_wire {self.intra_wire!r} is not supported: "
                f"difference-coded wires are gossip-only (they need the "
                f"γ-damped update against a tracked estimate) and cannot "
                f"realize the intra-pod allreduce — use f32/bf16/int8 "
                f"intra-pod and save topk for the inter-pod ring")
        if self.pod_size < 1:
            raise ValueError(f"pod_size must be >= 1, got {self.pod_size}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")
        if not 0.0 <= self.gossip_gamma <= 1.0:
            raise ValueError(f"gossip_gamma must be in [0, 1] (0 = auto), "
                             f"got {self.gossip_gamma}")
        if self.staleness_lambda < 0.0:
            raise ValueError(f"staleness_lambda must be >= 0, "
                             f"got {self.staleness_lambda}")

    @property
    def resolved_gamma(self) -> float:
        return self.gossip_gamma or min(0.5, self.topk_frac)

    # -- state ----------------------------------------------------------
    @property
    def needs_state(self) -> bool:
        """True when the wire carries an error-feedback residual that must
        live in the strategy state (threaded through the train step)."""
        return _needs_ef(self.wire)

    def init_comm(self, params) -> dict:
        """Error-feedback state: per-sender residual + shared public
        estimate, f32 zeros whatever the parameter dtype (a bf16 running
        sum stops absorbing residuals below its ulp); the hierarchical
        one lives in the pod-mean domain, (L / pod_size, ...)."""
        comm = {}
        if _needs_ef(self.wire):
            def main_shape(w):
                s = tuple(w.shape)
                if self.topology == "hierarchical":
                    s = (s[0] // self.pod_size,) + s[1:]
                return torch.zeros(s, dtype=torch.float32, device=w.device)
            comm["residual"] = tree_map(main_shape, params)
            comm["estimate"] = tree_map(main_shape, params)
        return comm

    # -- mixing ---------------------------------------------------------
    def make_mixer(self, n_learners: int):
        """``mix(params, step, comm) -> (mixed, comm)`` over the stacked
        learner axis (``step`` a host int).  With ``wire='f32'`` and no
        bucketing the fast path delegates to the pure-topology mixers of
        :mod:`repro_torch.core.mixing`, as the reference does."""
        t = self
        if t.topology == "hierarchical" and n_learners % t.pod_size:
            raise ValueError(
                f"hierarchical topology needs pod_size ({t.pod_size}) to "
                f"divide n_learners ({n_learners})")
        if t.topology == "exp":
            m = max(int(np.log2(max(n_learners, 1))), 1)
            if 2 ** m != n_learners and n_learners != 1:
                raise ValueError("exp topology wants power-of-2 learners, "
                                 f"got {n_learners}")

        # the fast path must also rule out a lossy INTRA-pod codec, which
        # only bites when the hierarchical intra stage actually exists
        plain_intra = (t.topology != "hierarchical" or t.pod_size == 1
                       or t.intra_wire == "f32")
        plain_wire = (t.wire == "f32" and t.bucket_bytes == 0
                      and plain_intra)
        if plain_wire and not t.needs_state:
            if t.topology == "none":
                return lambda p, step, comm: (p, comm)
            if t.topology == "uniform":
                return lambda p, step, comm: (mixing.mix_uniform(p), comm)
            if t.topology == "ring" or (t.topology == "hierarchical"
                                        and t.pod_size == 1):
                return lambda p, step, comm: (mixing.mix_ring(p), comm)
            if t.topology == "hierarchical" and t.pod_size == n_learners:
                return lambda p, step, comm: (mixing.mix_uniform(p), comm)
            if t.topology == "hierarchical":
                return lambda p, step, comm: (mixing.mix_hierarchical(
                    p, pod_size=t.pod_size), comm)
            if t.topology == "exp":
                exp = mixing.make_exp_mixer(n_learners)
                return lambda p, step, comm: (exp(p, step), comm)

        return lambda p, step, comm: _general_mix(t, p, step, comm)

    def make_elastic_mixer(self, n_learners: int, *, fault_seed: int = 0,
                           with_corruption: bool = False):
        """Elastic-membership mixing: returns

            ``mix(params, step, active, staleness, edge_ok, corrupt)
              -> mixed``

        where ``active``, ``edge_ok`` and ``corrupt`` are one
        ``FaultPlan.step_inputs`` dict's host arrays and ``staleness`` the
        per-learner counters of the strategy state, ``step`` a host int.
        The topology is rebuilt every step over the live set
        (:func:`repro_torch.core.mixing.elastic_matrix`, on the host):
        dead learners are identity rows, dropped edges return their mass
        to the diagonal, and with ``staleness_lambda`` > 0 a learner s
        steps behind is down-weighted by 1/(1 + λ·s).  The matrix is
        copied to the params' device once a step; each leaf's f32 (L, n)
        view is coded by ``wire`` (``intra_wire`` does not apply: the
        hierarchical stages are one matrix) and mixed as ``off @ d +
        diag * w``, the local replica exact, the product in full f32.

        Difference-coded wires (topk) are refused: their shared public
        estimate desynchronizes when learners crash or rejoin.  With
        ``with_corruption``, each learner row r with ``corrupt[r] > 0``
        of the peer view picks up Gaussian noise of RMS ``corrupt[r] ·
        rms(d[r])``, drawn from a ``torch.Generator`` on the params'
        device seeded from (fault_seed, step, leaf index, r) alone
        (:func:`noise_seed`), so a resumed run draws the same noise; the
        reference draws ``jax.random.normal`` under
        ``fold_in(fold_in(PRNGKey(fault_seed), step), leaf)``, a stream
        the port does not reproduce."""
        t = self
        if t.needs_state:
            raise ValueError(
                f"wire {t.wire!r} is difference-coded (error-feedback "
                f"state) and cannot run under elastic membership: the "
                f"shared public estimate desynchronizes when learners "
                f"crash or rejoin — use an f32/bf16/int8 wire with "
                f"--fault-* runs")
        if t.topology == "hierarchical" and n_learners % t.pod_size:
            raise ValueError(
                f"hierarchical topology needs pod_size ({t.pod_size}) to "
                f"divide n_learners ({n_learners})")

        def matrix(step, active, staleness, edge_ok):
            return mixing.elastic_matrix(
                active, t.topology, step=int(step), pod_size=t.pod_size,
                staleness=staleness, staleness_lambda=t.staleness_lambda,
                edge_ok=edge_ok)

        def mix(params, step, active, staleness, edge_ok, corrupt):
            if t.topology == "none":
                return params
            T = matrix(step, active, staleness, edge_ok)
            dev = next(_leaves(params)).device
            _require_full_f32(dev)
            diag = torch.diagonal(T).clone()
            off = (T - torch.diag(diag)).to(dev)
            diag = diag.to(dev)[:, None]
            hit = (np.nonzero(np.asarray(corrupt) > 0)[0]
                   if with_corruption else ())
            scale = np.asarray(corrupt, np.float32)
            leaves = list(_leaves(params))

            def one(i, w):
                wf = w.float().reshape(n_learners, -1)
                d = _coded(t, t.wire, wf)
                if len(hit):
                    d = d.clone()
                    for r in hit:
                        gen = torch.Generator(device=dev).manual_seed(
                            noise_seed(fault_seed, step, i, int(r)))
                        noise = torch.randn(d.shape[1], generator=gen,
                                            dtype=torch.float32, device=dev)
                        rms = torch.sqrt(torch.mean(d[r] * d[r]))
                        d[r] = d[r] + float(scale[r]) * rms * noise
                # peers arrive through the (coded, possibly corrupted)
                # wire; the local replica contributes exactly
                out = off @ d + diag * wf
                return out.reshape(w.shape).to(w.dtype)

            mixed = iter([one(i, w) for i, w in enumerate(leaves)])
            return tree_map(lambda _: next(mixed), params)

        mix.matrix = matrix
        return mix

    # -- telemetry ------------------------------------------------------
    def wire_bytes(self, params) -> float:
        """Analytic bytes SENT per learner per mixing round, from leaf
        shapes only: ring = 2 payloads (1 when L == 2), uniform =
        2(L-1)/L (ring-allreduce schedule regardless of codec), exp = 1,
        hierarchical = intra uniform over the pod + the pod ring amortized
        over its members."""
        total = 0.0
        for leaf in _leaves(params):
            L = int(leaf.shape[0])
            n = int(np.prod(leaf.shape[1:])) if len(leaf.shape) > 1 else 1
            if self.topology == "hierarchical":
                p = self.pod_size
                pods = L // p
                intra = (0.0 if p == 1 else
                         2.0 * (p - 1) / p
                         * self._payload_bytes(self.intra_wire, n))
                inter = (0.0 if pods == 1 else
                         _ring_sends(pods)
                         * self._payload_bytes(self.wire, n) / p)
                total += intra + inter
            else:
                mult = {
                    "none": 0.0,
                    "ring": _ring_sends(L),
                    "uniform": 2.0 * (L - 1) / L,
                    "exp": 1.0 if L > 1 else 0.0,
                }[self.topology]
                total += mult * self._payload_bytes(self.wire, n)
        return total

    def _payload_bytes(self, wire: str, n: int) -> float:
        """Coded size of one sender's n-element tensor, incl. per-bucket
        codec overheads (int8 scale, topk value+index pairs)."""
        sizes = _bucket_sizes(n, self.bucket_bytes)
        if wire == "f32":
            return 4.0 * n
        if wire == "bf16":
            return 2.0 * n
        if wire == "int8":
            return float(n + 4 * len(sizes))
        if wire == "topk":
            return float(sum(8 * _topk_k(s, self.topk_frac) for s in sizes))
        raise ValueError(wire)


# ---------------------------------------------------------------------------
# General (coded / bucketed) mixing path
# ---------------------------------------------------------------------------

def _bucket_sizes(n: int, bucket_bytes: int) -> list:
    """Column-bucket sizes of an n-element f32 payload — the one source of
    the bucketing rule, shared by the codec splitter and the wire-byte
    accounting."""
    if bucket_bytes <= 0 or n * 4 <= bucket_bytes:
        return [n]
    per = max(1, bucket_bytes // 4)
    return [min(per, n - i) for i in range(0, n, per)]


def _split_cols(x, bucket_bytes: int):
    """Split (G, n) into column buckets of <= bucket_bytes f32 payload."""
    sizes = _bucket_sizes(x.shape[1], bucket_bytes)
    if len(sizes) == 1:
        return [x]
    return list(torch.split(x, sizes, dim=1))


def _coded(t: Transport, wire: str, x):
    """Bucket-wise decode; returns the decoded full (G, n) tensor."""
    parts = [decode_payload(wire, c, t.topk_frac)
             for c in _split_cols(x, t.bucket_bytes)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _wire_stage(t: Transport, wire: str, x, ef):
    """One coded exchange of the (G, n) payload ``x``.

    Returns ``(peer_view, ef')``: what the receivers hold for each sender
    afterwards, and the updated error-feedback state.  Without error
    feedback the peer view is the decoded payload.  With it (topk),
    difference coding against the shared estimate [CHOCO-SGD]: payload =
    C(x − ŵ); every tracker applies ŵ ← ŵ + payload; the dropped mass
    (the residual) stays inside the next round's difference."""
    if not _needs_ef(wire):
        return _coded(t, wire, x), ef
    if ef is None:
        raise ValueError(
            f"wire {wire!r} carries error-feedback state: pass the same "
            f"Transport to init_state(...) so state['comm'] holds the "
            f"residual/estimate trees")
    _, est = ef
    delta = x - est
    d = _coded(t, wire, delta)
    est = est + d
    return est, (delta - d, est)


def _general_mix(t: Transport, params, step, comm):
    """Every leaf through :func:`_mix_leaf`; the EF trees are matched to
    the parameters by key."""
    comm = comm or {}
    step = int(step)
    if "residual" in comm:
        outs = tree_map(lambda w, r, e: _mix_leaf(t, w, step, (r, e)),
                        params, comm["residual"], comm["estimate"])
    else:
        outs = tree_map(lambda w: _mix_leaf(t, w, step, None), params)
    mixed = tree_map(lambda o: o[0], outs)
    new_comm = dict(comm)
    for key, idx in (("residual", 1), ("estimate", 2)):
        if key in comm:
            new_comm[key] = tree_map(lambda o, i=idx: o[i], outs)
    return mixed, new_comm


def _flat_ef(ef, G):
    """Error-feedback pair reshaped to the (G, n) payload domain."""
    if ef is None:
        return None
    return tuple(a.float().reshape(G, -1) for a in ef)


def _shaped_ef(ef_new, ef_orig):
    """Back to the stored leaf shapes (passthrough when no EF state)."""
    if ef_orig is None:
        return None, None
    if ef_new is None:
        return ef_orig
    return tuple(a.reshape(o.shape) for a, o in zip(ef_new, ef_orig))


def _combine(t: Transport, topology: str, ef_wire: bool, local, d, step):
    """Topology combine of the local (full-precision) value with the peer
    view ``d``.  Exact wires substitute peers' decoded payloads directly;
    difference-coded wires use the γ-damped CHOCO gossip
    ``local + γ·(T·ŵ − ŵ)``, which preserves the replica mean."""
    G = local.shape[0]
    if ef_wire:
        if topology == "ring":
            gossip = _combine_ring(d, d) - d
        elif topology == "uniform":
            gossip = mixing.ordered_mean(d, 0)[None] - d
        elif topology == "exp":
            gossip = _combine_exp(d, d, step, G) - d
        else:
            raise ValueError(topology)
        return local + t.resolved_gamma * gossip
    if topology == "ring":
        return _combine_ring(local, d)
    if topology == "uniform":
        return _combine_uniform(local, d)
    if topology == "exp":
        return _combine_exp(local, d, step, G)
    raise ValueError(topology)


def _mix_leaf(t: Transport, w, step: int, ef_main):
    """One leaf through the coded substrate.  Returns
    (mixed, residual', estimate')."""
    L = w.shape[0]
    new_main = None

    if L == 1 or t.topology == "none":
        mixed = w
    elif t.topology == "hierarchical":
        wf = w.float().reshape(L, -1)
        p = t.pod_size
        pods = L // p
        # intra-pod allreduce: contributions are reduced remotely, so the
        # pod mean is over coded payloads, own included
        if p == 1:
            pm = wf
        else:
            di = _coded(t, t.intra_wire, wf)
            pm = mixing.ordered_mean(di.reshape(pods, p, -1), 1)
        # inter-pod ring on the pod means
        if pods == 1:
            mixed_pm = pm
        else:
            d2, new_main = _wire_stage(t, t.wire, pm,
                                       _flat_ef(ef_main, pods))
            mixed_pm = _combine(t, "ring", _needs_ef(t.wire), pm, d2, step)
        out = mixed_pm[:, None, :].expand(pods, p, mixed_pm.shape[-1])
        mixed = out.reshape(w.shape).to(w.dtype)
    else:
        wf = w.float().reshape(L, -1)
        d, new_main = _wire_stage(t, t.wire, wf, _flat_ef(ef_main, L))
        mixed = _combine(t, t.topology, _needs_ef(t.wire), wf, d, step)
        mixed = mixed.reshape(w.shape).to(w.dtype)

    rm, em = _shaped_ef(new_main, ef_main)
    return mixed, rm, em
