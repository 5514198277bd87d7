"""Minimal functional optimizers — the port of ``repro.optim.optimizers``.

The paper's recipe is plain mini-batch SGD (Eq. 5) — no momentum state —
which is also what keeps per-learner replica memory at 1x params for the
decentralized strategies.  Momentum and Adam are provided for the
beyond-paper experiments.

Parameters are nested dicts of tensors.  Every update is computed in f32
and cast back to the weight's dtype, as the reference does; nothing is
updated in place.  Over stacked learners (a leading (L,) axis on every
leaf) the updates are elementwise and need no learner loop; Adam's step
count then carries one entry per learner, as under ``jax.vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested dicts of the same keys."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# a leaf of more elements than this goes through an elementwise update a
# block of slices at a time, so no f32 temporary of a whole stacked leaf
# is made (a 16-learner smollm-360m FFN weight is 4.7 GiB in f32)
SLICE_ELEMS = 2 ** 26


def slice_blocks(w, dim: int = 0) -> list:
    """(start, length) blocks of ``w``'s axis ``dim`` of at most
    ``SLICE_ELEMS`` elements each (one block for a small tensor)."""
    n = w.shape[dim]
    step = max(1, SLICE_ELEMS * n // max(w.numel(), 1))
    return [(i, min(step, n - i)) for i in range(0, n, step)]


def map_slices(fn, *tensors, dim: int = 0):
    """``fn(*tensors)`` for an ``fn`` that is elementwise along ``dim``
    (each slice's result depends on that slice alone): on tensors past
    ``SLICE_ELEMS`` elements evaluated over blocks of slices of ``dim``
    into one output, bit for bit the whole call's result."""
    w = tensors[0]
    if w.numel() <= SLICE_ELEMS or w.dim() <= dim:
        return fn(*tensors)
    out = None
    for i, n in slice_blocks(w, dim):
        part = fn(*(t.narrow(dim, i, n) for t in tensors))
        if out is None:
            out = part.new_empty(w.shape)
        out.narrow(dim, i, n).copy_(part)
    return out


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable       # (params, n_learners=None) -> opt_state
    update: Callable     # (grads, opt_state, params, lr) -> (new_params, opt_state)


def _zeros_f32(w):
    return torch.zeros(w.shape, dtype=torch.float32, device=w.device)


def sgd() -> Optimizer:
    def init(params, n_learners=None):
        return ()

    def update(grads, state, params, lr):
        new = tree_map(lambda w, g: map_slices(
            lambda w, g: (w.float() - lr * g.float()).to(w.dtype), w, g),
            params, grads)
        return new, state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params, n_learners=None):
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, lr):
        state = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        if nesterov:
            step_dir = tree_map(lambda m, g: beta * m + g.float(), state,
                                grads)
        else:
            step_dir = state
        new = tree_map(lambda w, d: (w.float() - lr * d).to(w.dtype),
                       params, step_dir)
        return new, state

    return Optimizer("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params, n_learners=None):
        lead = () if n_learners is None else (n_learners,)
        dev = next(iter(_leaves(params))).device
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros(lead, dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def step(w, m_, v_):
            # one bias correction per learner when t is (L,)
            c1 = bc1.reshape(bc1.shape + (1,) * (w.dim() - bc1.dim()))
            c2 = bc2.reshape(bc2.shape + (1,) * (w.dim() - bc2.dim()))
            return (w.float() - lr * (m_ / c1)
                    / (torch.sqrt(v_ / c2) + eps)).to(w.dtype)

        return tree_map(step, params, m, v), {"m": m, "v": v, "t": t}

    return Optimizer("adam", init, update)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def get_optimizer(name: str) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name]()
