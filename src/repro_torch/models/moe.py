"""Mixture-of-experts FFN — the port of ``repro.models.moe``, with its two
router implementations.

``dispatch`` — GShard/Switch-style capacity routing: tokens are grouped,
each token's top-k experts chosen, and a one-hot dispatch/combine moves
token activations into per-expert buffers of ``cap`` slots (a token past
its expert's capacity is dropped), in plain torch ops.

``dense`` — a token's output is the sum over every expert weighted by
its top-k combine weight (0 for an expert not selected): exact, no
token dropped.  It is ONE call of ``kernels/moe_dense.moe_dense`` on
all T tokens, on every device: on the card one call of the fused
dense-MoE kernel (the K10 port, which computes only the weighted
pairs; the hidden never reaches device memory), on the CPU its plain
version ``moe_dense_plain``, so both devices round the same function
the same way.  The reference's ``moe_dense_fused`` flag (the combine weights
rounded to bf16 and contracted jointly over experts and d_ff) selects
nothing here: the kernel keeps the router weights in f32.

The optional shared expert (llama4-scout) adds a SwiGLU or GELU FFN over
every token, in plain torch ops.  ``moe_apply`` returns ``(y, aux)`` with
the Switch-transformer load-balance loss ``aux`` (per learner over
learner-stacked weights: the training forward's call); ``moe_ffn``, which
the serving forward calls, returns ``y`` alone and builds no loss.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import moe_dense as MD
from repro_torch.models.common import gelu, linear
from repro_torch.params import ParamSpec


def moe_param_specs(cfg) -> dict:
    """router (d, E) f32; wi/wg (E, d, f), wo (E, f, d); the shared
    expert's (d, sff) / (sff, d) when configured.  The expert weights draw
    from normal(0, 1/fan_in) with fan_in their contracted axis (d for wi
    and wg, f for wo): the reference's lecun takes it from the leading
    axis, which for a stacked expert weight is the layer axis (and in the
    port's per-layer ``_stack`` would be E), too large a scale for a
    random-init stack to stay finite through 32 layers."""
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = cfg.param_dtype
    s_in, s_ff = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(ff))
    p = {
        "router": ParamSpec((d, E), "float32", "lecun",
                            axes=("embed", "experts")),
        "wi": ParamSpec((E, d, ff), dt, "normal", s_in,
                        ("experts", "embed", "expert_mlp")),
        "wg": ParamSpec((E, d, ff), dt, "normal", s_in,
                        ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((E, ff, d), dt, "normal", s_ff,
                        ("experts", "expert_mlp", "embed")),
    }
    if m.shared_expert:
        sff = m.shared_d_ff
        p["shared_wi"] = ParamSpec((d, sff), dt, "lecun",
                                   axes=("embed", "mlp"))
        p["shared_wg"] = ParamSpec((d, sff), dt, "lecun",
                                   axes=("embed", "mlp"))
        p["shared_wo"] = ParamSpec((sff, d), dt, "lecun",
                                   axes=("mlp", "embed"))
    return p


def _act(cfg, h, gate_fn):
    """swiglu: silu(gate) * h, the gate computed only when needed."""
    if cfg.act == "swiglu":
        return torch.nn.functional.silu(gate_fn()) * h
    return gelu(h)


def _expert_ffn(cfg, p, xe):
    """xe (E, g, cap, d) -> (E, g, cap, d): each expert's SwiGLU/GELU."""
    h = torch.einsum("egcd,edf->egcf", xe, p["wi"])
    h = _act(cfg, h, lambda: torch.einsum("egcd,edf->egcf", xe, p["wg"]))
    return torch.einsum("egcf,efd->egcd", h, p["wo"])


def _aux_loss(probs, expert_mask, num_experts: int):
    """Switch-transformer load-balance loss, per group then averaged.
    probs (g, s, E); expert_mask (g, s, E) in {0, 1} (any-k membership)."""
    density = expert_mask.float().mean(dim=1)             # (g, E)
    density_proxy = probs.mean(dim=1)                     # (g, E)
    return (density * density_proxy).mean() * (num_experts ** 2)


def route(cfg, p, xg):
    """The router of one call: xg (n_g, g, d) -> (probs (n_g, g, E) f32,
    the renormalised top-k weights (n_g, g, k) f32, their expert indices
    (n_g, g, k)).  The logits are a full-f32 product: a TF32 product
    would flip near-tied top-k selections."""
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_idx


def _group_size(router_group: int, T: int) -> int:
    """The largest divisor of T that fits the configured routing group."""
    g = min(router_group, T)
    while T % g:
        g -= 1
    return g


def _routed(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, router probs (n_g, g, E),
    top-k expert indices (n_g, g, k))."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    g_sz = _group_size(m.router_group, T)
    xg = x.reshape(T // g_sz, g_sz, d)
    probs, top_w, top_idx = route(cfg, p, xg)
    if m.router_impl == "dense":
        # the combine weight of each (token, expert): its top-k weight
        # where selected, else 0
        w_te = torch.zeros_like(probs).scatter_(-1, top_idx, top_w)
        y = MD.moe_dense(x.reshape(T, d).contiguous(), w_te.reshape(T, -1),
                         p["wi"], p["wg"], p["wo"], act=cfg.act)
    else:
        y = _dispatch(cfg, p, xg, top_w, top_idx)
    y = y.reshape(B, S, d)
    if m.shared_expert:
        h = x @ p["shared_wi"]
        h = _act(cfg, h, lambda: x @ p["shared_wg"])
        y = y + h @ p["shared_wo"]
    return y, probs, top_idx


def moe_ffn(cfg, p, x):
    """x (B, S, d) -> y (B, S, d) in x's dtype: the layer's FFN, without
    the auxiliary loss (the serving path's call)."""
    return _routed(cfg, p, x)[0]


def moe_apply(cfg, p, x, *, keep=None, slot=None):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (f32 scalar));
    or, with learner-stacked weights, x (L, B, S, d) -> (y (L, B, S, d),
    aux (L,)): each learner routes its own tokens in its own groups, as
    the reference's ``vmap`` over learners does.  On the card the
    learner-folded expert weights are kept in ``keep`` under ``slot`` (the
    layer; ``moe_dense.fold_experts``)."""
    if x.dim() == 4:
        return _moe_learners(cfg, p, x, keep, slot)
    y, probs, top_idx = _routed(cfg, p, x)
    E = cfg.moe.num_experts
    onehot = torch.nn.functional.one_hot(top_idx, E)
    return y, _aux_loss(probs, onehot.amax(dim=2), E)


def _moe_learners(cfg, p, x, keep, slot):
    """The training path of :func:`moe_apply`: x (L, B, S, d).  The
    router, softmax and top-k run per learner; the dense router's FFN is
    ONE call of ``moe_dense_learners`` for all L learners (K10 with the
    learners folded into its experts on the card); the aux loss is per
    learner, (L,)."""
    m = cfg.moe
    L, B, S, d = x.shape
    T = B * S
    g_sz = _group_size(m.router_group, T)
    xg = x.reshape(L, T // g_sz, g_sz, d)
    probs, top_w, top_idx = route_learners(cfg, p, xg)
    if m.router_impl == "dense":
        w_te = torch.zeros_like(probs).scatter(-1, top_idx, top_w)
        y = MD.moe_dense_learners(x.reshape(L, T, d), w_te.reshape(L, T, -1),
                                  p["wi"], p["wg"], p["wo"], act=cfg.act,
                                  keep=keep, slot=slot)
    else:
        y = _dispatch_learners(cfg, p, xg, top_w, top_idx)
    y = y.reshape(L, B, S, d)
    if m.shared_expert:
        h = linear(x, p["shared_wi"])
        h = _act(cfg, h, lambda: linear(x, p["shared_wg"]))
        y = y + linear(h, p["shared_wo"])
    E = m.num_experts
    mask = torch.nn.functional.one_hot(top_idx, E).amax(dim=3).float()
    aux = (mask.mean(dim=2) * probs.mean(dim=2)).mean(dim=(1, 2))
    return y, aux * (E ** 2)


def route_learners(cfg, p, xg):
    """:func:`route` per learner: xg (L, n_g, g, d) against the router (L,
    d, E) -> (probs, renormalised top-k weights, indices), each with the
    leading L."""
    logits = torch.einsum("lgsd,lde->lgse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_idx


def _slots(cfg, top_w, top_idx):
    """GShard capacity routing: a (token, k) slot takes the next free
    position in its expert's buffer of ``cap`` in (token, k) order within
    the group; slots past ``cap`` are dropped.  Returns the (n_g, g, E,
    cap) dispatch and combine tensors."""
    m = cfg.moe
    n_g, g_sz, _ = top_w.shape
    onehot = torch.nn.functional.one_hot(top_idx, m.num_experts).float()
    cap = max(int(g_sz * m.top_k * m.capacity_factor / m.num_experts), 1)
    flat = onehot.reshape(n_g, g_sz * m.top_k, m.num_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(onehot.shape)
    in_cap = (pos < cap).float() * onehot                  # keep mask
    # one-hot over the cap positions; a position past cap has none
    pos_oh = torch.nn.functional.one_hot(pos.long().clamp(max=cap),
                                         cap + 1)[..., :cap].float()
    dispatch = torch.einsum("gske,gskec->gsec", in_cap, pos_oh)
    combine = torch.einsum("gsk,gske,gskec->gsec", top_w, in_cap, pos_oh)
    return dispatch, combine


def _dispatch(cfg, p, xg, top_w, top_idx):
    """The capacity router's FFN: xg (n_g, g, d) through the slots of
    :func:`_slots`."""
    dispatch, combine = _slots(cfg, top_w, top_idx)
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(xg.dtype), xg)
    ye = _expert_ffn(cfg, p, xe)
    return torch.einsum("gsec,egcd->gsd", combine.to(ye.dtype), ye)


def _dispatch_learners(cfg, p, xg, top_w, top_idx):
    """:func:`_dispatch` per learner: xg (L, n_g, g, d).  The slots are a
    function of each group alone, so the learners' groups are routed as
    one stack of L·n_g groups; each learner's buffers then go through its
    own experts."""
    L, n_g = xg.shape[:2]
    dispatch, combine = _slots(cfg, top_w.flatten(0, 1),
                               top_idx.flatten(0, 1))
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(xg.dtype),
                      xg.flatten(0, 1))
    xe = xe.unflatten(1, (L, n_g)).movedim(1, 0)         # (L, E, g, cap, d)
    h = torch.einsum("legcd,ledf->legcf", xe, p["wi"])
    h = _act(cfg, h, lambda: torch.einsum("legcd,ledf->legcf", xe, p["wg"]))
    ye = torch.einsum("legcf,lefd->legcd", h, p["wo"])
    ye = ye.movedim(0, 1).flatten(1, 2)                   # (E, L·n_g, cap, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(ye.dtype), ye)
    return y.unflatten(0, (L, n_g))
