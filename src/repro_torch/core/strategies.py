"""Distributed training strategies (the paper's contribution, §IV-V) — the
port of the non-elastic step of ``repro.core.strategies``.

All strategies are expressed in the decentralized formalism of paper
Eq. 14 (W_{k+1} = W_k·T − α·g(Φ_k, ξ_k)):

==================  ==========  =========  ===========================
name                T (mixing)  Φ_k        paper reference
==================  ==========  =========  ===========================
sc_psgd             allreduce   W_k        §IV-B1 sync centralized, one
                                           replica (plain data-parallel
                                           SGD, Eq. 13 equivalence)
sc_psgd_replicated  T_u         W_k        the same over stacked replicas
sd_psgd             T_1 ring    W_k        §IV-C sync decentralized
ad_psgd             T_1 ring    W_{k-1}    §IV-C async decentralized:
                                           one-step-stale gradients
downpour            T_u         W_{k-1}    §IV-B2 async centralized
bmuf                block T_u   W_k local  §IV-B1 blockwise model-update
                                           filtering
hring               T_u in      W_{k-1}    §V hierarchical ring: pods
                    pods, T_1              average, the pod means ring
                    across
ad_psgd_q8          T_1, int8   W_{k-1}    §IV-D: AD-PSGD with int8
                                           neighbour payloads
ad_psgd_exp         exp graph   W_{k-1}    §IV-D: AD-PSGD on the
                                           one-peer exponential graph
==================  ==========  =========  ===========================

``topology``/``wire`` of a row are only its default
:class:`~repro_torch.core.transport.Transport`; any strategy runs over
any substrate configuration (``transport_from_cfg``), and wires with
error feedback carry their state in ``state['comm']``.

The learners are a stacked leading axis of every parameter leaf, on one
card.  Where the reference ``jax.vmap``s the per-learner gradient over
that axis (``strategies.py:366-367``), the port computes every learner's
loss in one pass whose kernels carry the learner axis on their grid, and
takes the gradient of the summed losses: each learner's loss depends
only on its own slice of the parameters, so that is each learner's own
gradient.  AD-PSGD's asynchrony is modeled as the reference models it,
as bounded staleness: the gradient is evaluated at the previous iterate
while the current one is mixed.

Variable-length batches (a ``lengths`` key) are aggregated with frame
weights: each learner's masked-mean gradient is scaled by its
valid-frame share, so uniform mixing equals the global masked gradient.

:func:`make_elastic_train_step` is the fault-tolerant variant: one
:class:`~repro_torch.core.faults.FaultPlan` step's host masks say who is
alive, who contributes a gradient, who rejoins, which gossip edges
deliver and whose payloads are corrupted, and the strategy runs over the
live set through the elastic mixing matrices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core.transport import Transport
from repro_torch.optim.optimizers import Optimizer, tree_map


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in tree}
    return next(it)


def split_learner_batch(batch, n_learners: int):
    """(B, ...) -> (L, B/L, ...) on every input leaf; raises a ValueError
    naming the key when B is not a multiple of the learner count."""
    if n_learners < 1:
        raise ValueError(
            f"n_learners={n_learners}: cannot split a batch over an empty "
            f"learner set — at least one learner must be active")

    def one(key, x):
        B = x.shape[0]
        if B % n_learners != 0:
            raise ValueError(
                f"global batch size B={B} (batch key {key!r}) is not "
                f"divisible by n_learners={n_learners}; every batch leaf "
                f"needs leading dim a multiple of the learner count so "
                f"each learner gets an equal shard (got remainder "
                f"{B % n_learners})")
        return x.reshape(n_learners, B // n_learners, *x.shape[1:])

    return {k: one(k, v) for k, v in batch.items()}


def check_active(active) -> int:
    """Host-side guard against a step with no live learner: frame-weighted
    aggregation over an empty learner set is 0/0 and mixing has no
    survivor to freeze toward.  Call it on the step's activity mask
    before the elastic step; returns the live count.  ``FaultPlan``
    applies the same rule to every membership event at construction."""
    n = int(np.asarray(active).sum())
    if n <= 0:
        raise ValueError(
            "no active learners this step: frame-weighted aggregation "
            "over an empty learner set is 0/0 and mixing has no "
            "survivor to freeze toward — fix the fault plan so at least "
            "one learner stays alive (FaultPlan raises the same error "
            "at construction)")
    return n


def _valid_frames(batch):
    """(L,) valid-frame counts per learner, or None for rectangular
    batches."""
    if "lengths" in batch:
        lens = batch["lengths"].float()
        return lens.sum(dim=tuple(range(1, lens.dim())))
    return None


def _value_and_grad(loss_fn, params, batch):
    """Per-learner losses (L,) and their gradients, stacked like params."""
    leaves = [w.detach().requires_grad_(True) for w in _leaves(params)]
    loss = loss_fn(_unflatten(params, iter(leaves)), batch)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), _unflatten(params, iter(grads))


def _accumulated_grad(loss_fn, params, batch, n_micro: int):
    """Gradient with optional microbatch accumulation (memory knob).

    When the batch carries ``lengths``, microbatches are combined with
    frame weights (each microbatch's masked-mean loss/grad scaled by its
    valid-frame count) so the result equals the masked mean over the
    whole batch, not the mean-of-means; the accumulated gradient is
    f32."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def slice_micro(x):
        # split on the MINOR position of each learner's batch dim
        # (strided microbatches), as the reference does
        L, B = x.shape[:2]
        return x.reshape(L, B // n_micro, n_micro, *x.shape[2:]).movedim(
            2, 0)

    mb = {k: slice_micro(v) for k, v in batch.items()}
    weighted = "lengths" in batch
    acc = tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                         device=w.device), params)
    loss_acc = wsum = 0.0
    for i in range(n_micro):
        mbatch = {k: v[i] for k, v in mb.items()}
        loss, g = _value_and_grad(loss_fn, params, mbatch)
        w = (_valid_frames(mbatch) if weighted
             else torch.ones_like(loss))
        acc = tree_map(lambda a, b: a + _per_learner(w, a) * b.float(),
                       acc, g)
        loss_acc = loss_acc + w * loss
        wsum = wsum + w
    scale = 1.0 / torch.clamp(wsum, min=1e-6)
    return loss_acc * scale, tree_map(lambda x: x * _per_learner(scale, x),
                                      acc)


def _per_learner(v, like):
    """(L,) -> broadcastable against a stacked leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def consensus_distance(params):
    """Mean L2 distance of learner replicas from their average — the
    consensus diagnostic for decentralized SGD (paper §IV-C)."""
    num = den = 0.0
    for w in _leaves(params):
        if w.dim() == 0 or w.shape[0] == 1:
            den = den + 1.0
            continue
        wf = w.float()
        num = num + torch.sum(torch.square(wf - wf.mean(0, keepdim=True)))
        den = den + wf.numel()
    return torch.sqrt(torch.as_tensor(num / den))


# ---------------------------------------------------------------------------
# Strategy definitions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Strategy:
    """A distributed training strategy built around paper Eq. 14;
    ``topology``/``wire`` name its default Transport."""

    name: str
    topology: str
    wire: str = "f32"
    stale: bool = False         # gradients at W_{k-1} (async modeling)
    replicated: bool = True     # params carry a leading learner axis
    block_size: int = 0         # >0: BMUF block length (in steps)
    block_momentum: float = 0.9
    block_lr: float = 1.0


STRATEGIES = {
    "sc_psgd": Strategy("sc_psgd", topology="uniform", replicated=False),
    "sc_psgd_replicated": Strategy("sc_psgd_replicated", topology="uniform"),
    "sd_psgd": Strategy("sd_psgd", topology="ring"),
    "ad_psgd": Strategy("ad_psgd", topology="ring", stale=True),
    "downpour": Strategy("downpour", topology="uniform", stale=True),
    # BMUF mixes only at block boundaries; 'uniform' is the block sync
    "bmuf": Strategy("bmuf", topology="uniform", block_size=16),
    "hring": Strategy("hring", topology="hierarchical", stale=True),
    "ad_psgd_q8": Strategy("ad_psgd_q8", topology="ring", wire="int8",
                           stale=True),
    "ad_psgd_exp": Strategy("ad_psgd_exp", topology="exp", stale=True),
}


def get_strategy(name: str) -> Strategy:
    return STRATEGIES[name]


def default_transport(strategy: Strategy) -> Transport:
    return Transport(topology=strategy.topology, wire=strategy.wire)


def transport_from_cfg(cfg, strategy: Strategy) -> Transport:
    """Resolve the ``comm_*`` knobs of an ArchConfig against the strategy
    defaults (empty string = keep the strategy default)."""
    return Transport(
        topology=cfg.comm_topology or strategy.topology,
        wire=cfg.comm_wire or strategy.wire,
        intra_wire=cfg.comm_intra_wire or "f32",
        bucket_bytes=int(cfg.comm_bucket_mb * 2 ** 20),
        pod_size=cfg.comm_pod_size or 1,
        topk_frac=cfg.comm_topk_frac,
        staleness_lambda=cfg.comm_staleness_lambda,
    )


# ---------------------------------------------------------------------------
# Train state / step builder
# ---------------------------------------------------------------------------

def _clone(tree):
    return tree_map(torch.clone, tree)


def _learner_dim(params) -> int:
    return next(_leaves(params)).shape[0]


def init_state(strategy: Strategy, params, optimizer: Optimizer,
               transport: Optional[Transport] = None):
    """params: already stacked with the learner dim if
    strategy.replicated.  ``step`` is a host int.  Pass the SAME
    ``transport`` given to :func:`make_train_step`: wires with error
    feedback (topk) carry their residual and estimate in
    ``state['comm']`` (f32 whatever the parameter dtype)."""
    transport = transport if transport is not None \
        else default_transport(strategy)
    L = _learner_dim(params) if strategy.replicated else None
    state = {
        "params": params,
        "opt": optimizer.init(params, L if L and L > 1 else None),
        "step": 0,
    }
    # distinct buffers, never aliases of params
    if strategy.stale:
        state["prev_params"] = _clone(params)
    if strategy.block_size:
        state["anchor"] = _clone(params)
        state["block_mom"] = tree_map(
            lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                  device=w.device), params)
    if strategy.replicated and transport.needs_state:
        state["comm"] = transport.init_comm(params)
    return state


def stack_for_learners(params, n_learners: int):
    """Replicate freshly-initialized params into the stacked learner axis
    (real copies: the kernels take contiguous operands)."""
    return tree_map(lambda w: w.unsqueeze(0).expand(
        (n_learners,) + tuple(w.shape)).contiguous(), params)


def average_learners(params):
    """Collapse replicas to the consensus model (for eval/checkpoint)."""
    return tree_map(lambda w: w.float().mean(0).to(w.dtype), params)


def _grad_norm(g):
    """Global L2 norm of a gradient tree (f32 accumulation)."""
    return torch.sqrt(sum(torch.sum(torch.square(w.float()))
                          for w in _leaves(g)))


def _grad_norm_stacked(g_l):
    """(L,) per-learner L2 norms of a stacked gradient tree."""
    return torch.sqrt(sum(
        torch.sum(torch.square(w.float()), dim=tuple(range(1, w.dim())))
        for w in _leaves(g_l)))


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(strategy: Strategy, loss_fn: Callable,
                    optimizer: Optimizer, lr_schedule: Callable, *,
                    n_learners: int = 1, microbatches: int = 1,
                    with_consensus: bool = False, pre_split: bool = False,
                    transport: Optional[Transport] = None,
                    with_grad_norm: bool = False):
    """Build the train step ``step(state, batch) -> (state', metrics)``.

    ``loss_fn(params, batch) -> (L,)`` takes stacked params and a batch
    split over learners (L, B/L, ...), and returns each learner's loss.
    The batch (numpy arrays or tensors, flat (B, ...), or with
    ``pre_split`` already shaped (L, B/L, ...)) is moved to the
    parameters' device.  Batches carrying ``lengths`` get frame-weighted
    aggregation, and the reported loss is the frame-weighted mean.
    Replicated steps report ``wire_bytes``, the analytic bytes each
    learner sends this step (0 on BMUF's non-sync steps), and carry
    ``state['comm']`` through the transport's mixer.
    ``with_consensus`` adds ``metrics['consensus']``
    (:func:`consensus_distance` of the new parameters);
    ``with_grad_norm`` adds ``metrics['grad_norm']``, the L2 norm of the
    applied gradient (the mean of the per-learner norms on replicated
    strategies)."""
    transport = transport if transport is not None \
        else default_transport(strategy)
    mix = (transport.make_mixer(n_learners) if strategy.replicated
           else None)

    def grad_one(params, batch):
        return _accumulated_grad(loss_fn, params, batch, microbatches)

    def step(state, batch):
        lr = lr_schedule(state["step"])
        device = next(_leaves(state["params"])).device
        batch = _to_device(batch, device)
        metrics = {}

        if not strategy.replicated:
            # plain data-parallel SGD on one replica: a learner axis of 1
            one = tree_map(lambda w: w.unsqueeze(0), state["params"])
            loss, g = grad_one(one, {k: v.unsqueeze(0)
                                     for k, v in batch.items()})
            g = tree_map(lambda x: x.squeeze(0), g)
            new_params, opt = optimizer.update(g, state["opt"],
                                               state["params"], lr)
            metrics["loss"] = loss[0]
            if with_grad_norm:
                metrics["grad_norm"] = _grad_norm(g)
            return {"params": new_params, "opt": opt,
                    "step": state["step"] + 1}, metrics

        lbatch = batch if pre_split else split_learner_batch(batch,
                                                             n_learners)
        grad_at = state["prev_params"] if strategy.stale else state["params"]
        loss_l, g_l = grad_one(grad_at, lbatch)
        frames = _valid_frames(lbatch)
        if frames is not None:
            # frame-weighted aggregation: each learner's masked-mean
            # gradient scaled by its valid-frame share, cast back to the
            # gradient's dtype
            w = frames / torch.clamp(frames.mean(), min=1e-6)
            g_l = tree_map(lambda g: (g.float() * _per_learner(w, g)).to(
                g.dtype), g_l)
            metrics["loss"] = (torch.sum(loss_l * frames)
                               / torch.clamp(frames.sum(), min=1e-6))
        else:
            metrics["loss"] = loss_l.mean()
        if with_grad_norm:
            metrics["grad_norm"] = _grad_norm_stacked(g_l).mean()

        comm = state.get("comm", {})
        wire_bytes = transport.wire_bytes(state["params"])
        if strategy.block_size:
            # BMUF: local SGD inside a block; blockwise model-update
            # filtering at block boundaries
            upd, opt = optimizer.update(g_l, state["opt"], state["params"],
                                        lr)
            step_no = state["step"] + 1
            out = {"params": upd, "opt": opt, "step": step_no,
                   "anchor": state["anchor"],
                   "block_mom": state["block_mom"]}
            if step_no % strategy.block_size == 0:
                avg, comm = mix(upd, step_no, comm)
                mom = tree_map(
                    lambda m, a, b: strategy.block_momentum * m
                    + strategy.block_lr * (a.float() - b.float()),
                    state["block_mom"], avg, state["anchor"])
                new = tree_map(lambda b, m: (b.float() + m).to(b.dtype),
                               state["anchor"], mom)
                out.update(params=new, anchor=new, block_mom=mom)
                metrics["wire_bytes"] = wire_bytes
            else:
                metrics["wire_bytes"] = 0.0
        else:
            # Eq. 14: the current iterate is mixed while the gradient was
            # taken (at the previous iterate when stale)
            mixed, comm = mix(state["params"], state["step"], comm)
            new_params, opt = optimizer.update(g_l, state["opt"], mixed, lr)
            out = {"params": new_params, "opt": opt,
                   "step": state["step"] + 1}
            metrics["wire_bytes"] = wire_bytes

        if "comm" in state:
            out["comm"] = comm
        if strategy.stale:
            out["prev_params"] = state["params"]
        if with_consensus:
            metrics["consensus"] = consensus_distance(out["params"])
        return out, metrics

    return step


# ---------------------------------------------------------------------------
# Elastic (fault-tolerant) train step
# ---------------------------------------------------------------------------

def _sel(mask, a, b):
    """Per-learner select over stacked trees: rows where the host (L,)
    ``mask`` is set come from ``a``, the rest from ``b``.  An all-set or
    all-clear mask returns ``a`` or ``b`` itself (the select would copy
    it bit for bit)."""
    m = np.asarray(mask) > 0
    if m.all():
        return a
    if not m.any():
        return b

    def one(x, y):
        mt = torch.as_tensor(m, device=x.device).reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return torch.where(mt, x, y)

    return _map2(one, a, b)


def _map2(fn, a, b):
    """``fn`` leafwise over two trees of dicts, tuples and tensors (the
    optimizer states included: sgd's is ``()``)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _column(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host (L,) f32 vector on ``like``'s device, broadcastable against
    it."""
    return _per_learner(torch.as_tensor(v, dtype=torch.float32,
                                        device=like.device), like)


def _reseed_rejoiners(params, rejoin, incumbent):
    """Rejoining learners re-enter at the incumbents' f32 mean (the sum
    over learners in order, divided by their count); elastic membership
    never resurrects a crashed learner's dead weights.  Rows that do not
    rejoin keep their bits (f32 -> dtype of an upcast is exact), so a
    step with no rejoiner returns ``params`` itself."""
    rj = np.nonzero(np.asarray(rejoin) > 0)[0]
    if rj.size == 0:
        return params
    n_inc = float(max(np.float32(np.asarray(incumbent, np.float32).sum()),
                      np.float32(1.0)))
    idx = torch.as_tensor(rj)

    def one(w):
        wf = w.float()
        mu = mixing.div(mixing.ordered_sum(wf * _column(incumbent, w), 0),
                        n_inc)
        out = w.clone()
        out[idx.to(w.device)] = mu.to(w.dtype)
        return out

    return tree_map(one, params)


def _masked_consensus(params, active):
    """Consensus distance over the ACTIVE learners only (a crashed
    learner's frozen replica is cluster weather, not disagreement)."""
    a = np.asarray(active, np.float32)
    n_act = max(np.float32(a.sum()), np.float32(1.0))
    num, den = None, np.float32(0.0)
    for w in _leaves(params):
        if w.dim() == 0 or w.shape[0] == 1:
            part, d = torch.zeros((), device=w.device), np.float32(1.0)
        else:
            wf = w.float()
            col = _column(a, w)
            mu = mixing.div(mixing.ordered_sum(wf * col, 0), float(n_act))
            part = torch.sum(torch.square(wf - mu) * col)
            d = n_act * (np.float32(wf.numel()) / np.float32(wf.shape[0]))
        num = part if num is None else num + part
        den = np.float32(den + d)
    return torch.sqrt(mixing.div(num, float(den)))


def init_elastic_state(strategy: Strategy, params, optimizer: Optimizer,
                       transport: Optional[Transport] = None):
    """:func:`init_state` plus the per-learner staleness counters (steps
    since the learner last contributed a gradient), an int32 (L,) tensor.

    The counters live on the host (a CPU tensor, whatever the params'
    device): every input they depend on is a host mask, and the mixing
    matrix they damp is built on the host, so the step never reads the
    card for them.  The checkpoint saves and restores them there."""
    state = init_state(strategy, params, optimizer, transport)
    state["staleness"] = torch.zeros((_learner_dim(params),),
                                     dtype=torch.int32)
    return state


def make_elastic_train_step(strategy: Strategy, loss_fn: Callable,
                            optimizer: Optimizer, lr_schedule: Callable, *,
                            n_learners: int, microbatches: int = 1,
                            with_consensus: bool = False,
                            pre_split: bool = False,
                            transport: Optional[Transport] = None,
                            fault_seed: int = 0,
                            with_corruption: bool = False,
                            with_grad_norm: bool = False):
    """The fault-tolerant variant of :func:`make_train_step`:

        ``step(state, batch, faults) -> (state', metrics)``

    where ``faults`` is one ``FaultPlan.step_inputs`` dict of numpy
    arrays (active, contrib, rejoin, edge_ok, corrupt).  Semantics:

    * **membership** — mixing runs over the live set through the elastic
      matrices (the dead frozen bit for bit); rejoiners re-enter at the
      incumbents' f32 mean (``prev_params`` too for stale strategies)
      with a fresh optimizer state and zero staleness.
    * **stragglers/stalls** — a learner alive but not contributing still
      mixes but applies no gradient and keeps its optimizer state; its
      staleness grows, and ``transport.staleness_lambda`` > 0 damps its
      mixing influence by 1/(1 + λ·staleness).
    * **aggregation** — gradients are weighted w_l = n_active · f_l /
      Σ_contrib f over the contributors (f the valid frames, 1 a learner
      on rectangular batches); the loss is the contributors'
      frame-weighted mean and ``grad_norm`` the mean over contributors.
    * **wire faults** — dropped edges return their mixing mass to the
      diagonal; corrupted payloads (``with_corruption``) only reach the
      peer view, never the local replica.

    ``n_active``, ``n_contrib``, the staleness update and
    ``staleness_max`` depend on the host masks only and are computed on
    the host; ``wire_bytes`` is ``Transport.wire_bytes · n_active / L``.
    With the trivial masks the trajectory matches :func:`make_train_step`
    to f32 rounding (a matrix product where the plain path rolls).
    Non-replicated strategies are refused (no learner axis to mask), and
    difference-coded wires by :meth:`Transport.make_elastic_mixer`."""
    if not strategy.replicated:
        raise ValueError(
            f"strategy {strategy.name!r} is not replicated: elastic "
            f"membership needs a stacked learner axis to mask — use "
            f"'sc_psgd_replicated' for an elastic allreduce baseline")
    transport = transport if transport is not None \
        else default_transport(strategy)
    mix = transport.make_elastic_mixer(
        n_learners, fault_seed=fault_seed, with_corruption=with_corruption)

    def grad_one(params, batch):
        return _accumulated_grad(loss_fn, params, batch, microbatches)

    def step(state, batch, faults):
        lr = lr_schedule(state["step"])
        device = next(_leaves(state["params"])).device
        batch = _to_device(batch, device)
        metrics = {}
        f32 = np.float32
        active = np.asarray(faults["active"], f32)
        rejoin = np.asarray(faults["rejoin"], f32)
        gmask = active * np.asarray(faults["contrib"], f32)
        n_act = max(f32(active.sum()), f32(1.0))
        incumbent = active * (f32(1.0) - rejoin)

        # membership first: rejoiners re-enter at the incumbents' mean
        params = _reseed_rejoiners(state["params"], rejoin, incumbent)
        opt = state["opt"]
        if rejoin.any():
            opt = _sel(rejoin, optimizer.init(
                params, n_learners if n_learners > 1 else None), opt)
        staleness = np.where(rejoin > 0, 0,
                             state["staleness"].cpu().numpy()).astype(
                                 np.int32)

        lbatch = batch if pre_split else split_learner_batch(batch,
                                                             n_learners)
        grad_at = params
        if strategy.stale:
            grad_at = _reseed_rejoiners(state["prev_params"], rejoin,
                                        incumbent)
        loss_l, g_l = grad_one(grad_at, lbatch)

        frames = _valid_frames(lbatch)
        if frames is None:
            frames = torch.ones(n_learners, device=device)
        gm = torch.as_tensor(gmask, device=device)
        cframes = gm * frames
        csum = torch.clamp(mixing.ordered_sum(cframes, 0), min=1e-6)
        # the mean over the active learners of the applied gradients is
        # the global masked gradient over the contributors
        w = torch.as_tensor(n_act, device=device) * cframes / csum
        g_l = tree_map(lambda g: (g.float() * _per_learner(w, g)).to(
            g.dtype), g_l)
        metrics["loss"] = mixing.ordered_sum(loss_l * cframes, 0) / csum
        if with_grad_norm:
            norms = _grad_norm_stacked(g_l)
            metrics["grad_norm"] = mixing.div(
                mixing.ordered_sum(norms * gm, 0),
                float(max(f32(gmask.sum()), f32(1.0))))

        wire_bytes = float(f32(transport.wire_bytes(params)) * n_act
                           / f32(n_learners))

        def elastic_mix(p, step_no):
            return mix(p, step_no, active, staleness, faults["edge_ok"],
                       faults["corrupt"])

        if strategy.block_size:
            # elastic BMUF: gated local SGD inside the block; at block
            # boundaries the survivors sync through the elastic matrix
            # while the dead keep params, anchor and momentum frozen
            anchor = _reseed_rejoiners(state["anchor"], rejoin, incumbent)
            mom = _sel(rejoin, tree_map(torch.zeros_like,
                                        state["block_mom"]),
                       state["block_mom"])
            upd, new_opt = optimizer.update(g_l, opt, params, lr)
            upd = _sel(gmask, upd, params)
            new_opt = _sel(gmask, new_opt, opt)
            step_no = state["step"] + 1
            out = {"params": upd, "opt": new_opt, "step": step_no,
                   "anchor": anchor, "block_mom": mom}
            if step_no % strategy.block_size == 0:
                avg = elastic_mix(upd, step_no)
                new_mom = tree_map(
                    lambda m, a, b: strategy.block_momentum * m
                    + strategy.block_lr * (a.float() - b.float()),
                    mom, avg, anchor)
                new = tree_map(lambda b, m: (b.float() + m).to(b.dtype),
                               anchor, new_mom)
                out.update(params=_sel(active, new, upd),
                           anchor=_sel(active, new, anchor),
                           block_mom=_sel(active, new_mom, mom))
                metrics["wire_bytes"] = wire_bytes
            else:
                metrics["wire_bytes"] = 0.0
        else:
            mixed = elastic_mix(params, state["step"])
            upd, new_opt = optimizer.update(g_l, opt, mixed, lr)
            # contributors step from the mixed iterate; alive
            # non-contributors keep the mixed iterate (they gossiped but
            # computed nothing); the dead stay exactly where they were
            out = {"params": _sel(active, _sel(gmask, upd, mixed), params),
                   "opt": _sel(gmask, new_opt, opt),
                   "step": state["step"] + 1}
            metrics["wire_bytes"] = wire_bytes

        if strategy.stale:
            out["prev_params"] = params
        new_stale = np.where(gmask > 0, 0, staleness + 1).astype(np.int32)
        out["staleness"] = torch.from_numpy(new_stale)
        metrics["n_active"] = float(n_act)
        metrics["n_contrib"] = float(f32(gmask.sum()))
        metrics["staleness_max"] = int((new_stale * (active > 0)).max())
        if with_consensus:
            metrics["consensus"] = _masked_consensus(out["params"], active)
        return out, metrics

    return step
