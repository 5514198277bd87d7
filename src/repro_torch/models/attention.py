"""Grouped-query attention — the port of ``repro.models.attention`` for the
decoders and the encoder-decoder (the GSPMD-only ``seq_shard`` modes are
not carried: the port runs on one card).

* ``attn_seq``    — full-sequence attention: the reference's plain
  q-chunked path, in torch ops (bf16 products, f32 softmax, p cast to
  the value dtype before p·v), with a masked ragged last chunk where the
  reference asserts Sq % q_chunk == 0.
* ``attn_prefill`` — the model's prefill attention, causal or (an
  encoder's, a cross-attention's) not: on the card the flash-attention
  kernel (the K11 port, any prompt length), on the CPU ``attn_seq``, the
  reference model's own prefill math.
* ``attn_decode`` / ``attn_decode_delta`` — the single-token step
  against a dense cache (B, S, KV, E) or, with ``page_table``, a page
  pool (n_pages, P, KV, E).  Both go through the decode-attention
  wrappers of ``repro_torch.kernels.decode_attention`` (the K7 and K8
  ports on the card, their plain versions on the CPU); the delta variant
  attends over the old cache plus the new token's column, so the cache is
  written once per step, after the layer loop.
* ``attn_decode_ref`` / ``attn_decode_delta_ref`` — the reference's jnp
  decode math op for op (bf16 products, scores cast to f32, softmax in
  f32, p cast back to bf16), used by the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import plain_path
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.common import (apply_rope, linear, per_learner,
                                       rotate)
from repro_torch.params import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params and projections
# ---------------------------------------------------------------------------

def attn_param_specs(cfg, *, dtype=None) -> dict:
    dt = dtype or cfg.param_dtype
    d, H, KV, E = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ParamSpec((d, H, E), dt, "lecun",
                        axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, E), dt, "lecun",
                        axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, E), dt, "lecun",
                        axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, E, d), dt, "lecun",
                        axes=("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        p["bq"] = ParamSpec((H, E), "float32", "zeros",
                            axes=("heads", "head_dim"))
        p["bk"] = ParamSpec((KV, E), "float32", "zeros",
                            axes=("kv_heads", "head_dim"))
        p["bv"] = ParamSpec((KV, E), "float32", "zeros",
                            axes=("kv_heads", "head_dim"))
        p["bo"] = ParamSpec((d,), "float32", "zeros", axes=("embed",))
    return p


def qkv_project(cfg, p, xq, xkv, positions_q=None, positions_kv=None, *,
                rope=None):
    """x (B, S, d) -> q (B, S, H, E), k and v (B, S, KV, E), each one
    matmul against the (d, heads * E) view of its weight; or, with
    learner-stacked weights, x (L, B, S, d) -> (L, B, S, heads, E), one
    batched product per weight.  ``rope`` is a precomputed (sin, cos) pair
    (:func:`~repro_torch.models.common.rope_angles`) applied to q and k in
    place of ``positions_*``."""
    H, KV, E = p["wq"].shape[-2], p["wk"].shape[-2], p["wq"].shape[-1]
    q = linear(xq, p["wq"].flatten(-2)).view(*xq.shape[:-1], H, E)
    k = linear(xkv, p["wk"].flatten(-2)).view(*xkv.shape[:-1], KV, E)
    v = linear(xkv, p["wv"].flatten(-2)).view(*xkv.shape[:-1], KV, E)
    if "bq" in p:
        q = (q.float() + per_learner(p["bq"], 2, q.dim())).to(q.dtype)
        k = (k.float() + per_learner(p["bk"], 2, k.dim())).to(k.dtype)
        v = (v.float() + per_learner(p["bv"], 2, v.dim())).to(v.dtype)
    if rope is not None:
        return rotate(q, *rope), rotate(k, *rope), v
    if positions_q is not None:
        q = apply_rope(q, positions_q, cfg.rope_theta)
    if positions_kv is not None:
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def out_project(p, o):
    """o (B, S, H, E) -> (B, S, d) through the (H * E, d) view of wo (or
    per learner, o (L, B, S, H, E) against wo (L, H, E, d))."""
    y = linear(o.flatten(-2), p["wo"].flatten(-3, -2))
    if "bo" in p:
        y = (y.float() + per_learner(p["bo"], 1, y.dim())).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------

def attn_seq(q, k, v, *, causal: bool, window=None, q_chunk: int = 512,
             pos_offset: int = 0):
    """q (B, Sq, H, E), k/v (B, Sk, KV, E) -> (B, Sq, H, E).  A window >=
    Sk is full attention.  Any Sq: the last of the q_chunk-row chunks may
    be shorter (each row's softmax is its own, so the chunking changes no
    value)."""
    B, Sq, H, E = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, M = KV, H // KV
    scale = 1.0 / np.sqrt(E)
    k_pos = torch.arange(Sk, device=q.device)
    qg = q.reshape(B, Sq, G, M, E)
    q_chunk = min(q_chunk, Sq)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qs = qg[:, c0:c0 + q_chunk]
        s = torch.einsum("bcgme,btge->bgmct", qs, k).float() * scale
        if causal:
            q_pos = pos_offset + c0 + torch.arange(qs.shape[1],
                                                   device=q.device)
            ok = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(ok[None, None, None], s,
                            torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bgmct,btge->bcgme", p, v))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.reshape(B, Sq, G * M, E)


def attn_prefill(q, k, v, *, window=None, causal: bool = True):
    """Full-sequence attention of a prompt: q (B, Sq, H, E), k/v (B, Sk,
    KV, E) -> (B, Sq, H, E).  Causal (self-attention, Sq = Sk; ``window``
    None or past S is full attention), or with ``causal=False`` every
    query sees every key, for any Sq and Sk (an encoder's self-attention,
    a decoder's cross-attention over the encoder output; the window plays
    no part).  On the card the K11 kernel (``kernels.flash_attention``);
    on the CPU :func:`attn_seq`.  Both round p to bf16 once before p·v, as
    the reference's prefill does.  A branch on the device, not a fallback:
    the card never runs ``attn_seq``.  A leading learner axis (q (L, B,
    Sq, H, E), k/v (L, B, Sk, KV, E)) folds into the batch: one call for
    every learner.  Differentiable on both devices (on the card through
    K11's autograd Function)."""
    if q.dim() == 5:
        out = attn_prefill(q.flatten(0, 1), k.flatten(0, 1),
                           v.flatten(0, 1), window=window, causal=causal)
        return out.view(q.shape)
    if plain_path(q):
        return attn_seq(q, k, v, causal=causal, window=window)
    return FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def attn_decode(q, k_cache, v_cache, pos, *, window=None, page_table=None):
    """q (B, 1, H, E); caches (B, S, KV, E) already holding the new token
    at ``pos`` (or page pools read through ``page_table`` (B, W)).
    Positions > pos and outside the window are masked."""
    q = q.contiguous()
    if page_table is not None:
        return DA.paged_decode_attention(q, k_cache, v_cache, page_table,
                                         pos, window=window)
    return DA.decode_attention(q, k_cache, v_cache, pos, window=window)


def attn_decode_delta(q, k_cache, v_cache, k_new, v_new, pos, *,
                      window=None, page_table=None):
    """Decode without writing the cache first: attend over the old cache
    (positions < pos) plus the new token's column ``k_new``/``v_new``
    (B, 1, KV, E).  Equal to writing the token and calling
    :func:`attn_decode`; the pages are only read here."""
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    if page_table is not None:
        return DA.paged_decode_attention(q, k_cache, v_cache, page_table,
                                         pos, window=window, k_new=k_new,
                                         v_new=v_new)
    return DA.decode_attention(q, k_cache, v_cache, pos, window=window,
                               k_new=k_new, v_new=v_new)


def attn_decode_ref(q, k_cache, v_cache, pos, *, window=None):
    """The reference's jnp ``attn_decode`` math (dense cache) in torch
    ops."""
    B, _, H, E = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, E)
    s = torch.einsum("bgme,btge->bgmt", qg, k_cache).float() / np.sqrt(E)
    t = torch.arange(S, device=q.device)
    ok = t <= pos
    if window is not None:
        ok = ok & (pos - t < window)
    s = torch.where(ok[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bgmt,btge->bgme", p, v_cache)
    return o.reshape(B, 1, H, E)


def attn_decode_delta_ref(q, k_cache, v_cache, k_new, v_new, pos, *,
                          window=None):
    """The reference's jnp ``attn_decode_delta`` math (dense cache) in
    torch ops."""
    B, _, H, E = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, E)
    s_old = torch.einsum("bgme,btge->bgmt", qg, k_cache).float() / np.sqrt(E)
    t = torch.arange(S, device=q.device)
    ok = t < pos                      # strictly old positions
    if window is not None:
        ok = ok & (pos - t < window)
    s_old = torch.where(ok[None, None, None], s_old,
                        torch.full_like(s_old, NEG_INF))
    s_new = (torch.einsum("bgme,bge->bgm", qg, k_new[:, 0]).float()
             / np.sqrt(E))[..., None]
    s = torch.cat([s_old, s_new], dim=-1)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = (torch.einsum("bgmt,btge->bgme", p[..., :S], v_cache)
         + p[..., S:] * v_new[:, 0][:, :, None, :])
    return o.reshape(B, 1, H, E)


def write_new_token(cache, new, pos, *, layer_stacked: bool = True):
    """Write the new token column in place: cache (L, B, S, KV, E) [or
    (B, S, KV, E)], new (L, B, 1, KV, E) [or (B, 1, KV, E)], at ``pos``.
    The reference returns an updated copy; the port updates the cache it
    is given (one column instead of a copy of the whole cache)."""
    if layer_stacked:
        cache[:, :, pos] = new[:, :, 0].to(cache.dtype)
    else:
        cache[:, pos] = new[:, 0].to(cache.dtype)
    return cache


def write_new_token_paged(cache, new, page_table, pos, page_size: int):
    """Paged counterpart of :func:`write_new_token`, in place: cache is
    the pool (L, n_pages, P, KV, E), new (L, B, 1, KV, E); request b's
    column lands at ``(page_table[b, pos // P], pos % P)``.  The target
    page is exclusively owned (copy-on-write runs first, host-side)."""
    page_ids = page_table[:, pos // page_size].long()          # (B,)
    cache[:, page_ids, pos % page_size] = new[:, :, 0].to(cache.dtype)
    return cache


def update_cache(cache, new, pos):
    """cache (B, S, KV, E), new (B, 1, KV, E) -> a copy with the column
    at ``pos`` replaced (the reference's functional update)."""
    out = cache.clone()
    out[:, pos] = new[:, 0].to(cache.dtype)
    return out
