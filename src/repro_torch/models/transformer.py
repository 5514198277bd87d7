"""Decoder-only stack: the dense, moe, ssm, hybrid and vlm families of
``repro.models.transformer`` — parameter specs, the sequence forward
(prefill), the one-token decode step, and the decode-state layouts
(dense KV rows or a page pool for the dense, moe and vlm families;
per-slot conv windows and SSM states for the ssm family; both halves, KV
rows and SSM states, for the hybrid family).

Layers are stacked along a leading axis L, as the reference stacks them
for ``lax.scan``; here a Python loop walks them.  Prefill attention is ``attention.attn_prefill`` (the K11 kernel
on the card).  A hybrid layer runs attention and the Mamba-2 block on
the same normed input and adds the mean of their rmsnormed outputs
(Hymba's fusion) before its FFN.  A moe layer's FFN is
``moe.moe_ffn`` (the K10 kernel on the card under the dense router);
its auxiliary loss is not built, as the reference's decode discards it.
A vlm layer is a dense layer; the family's prefill may put image patch
embeddings (a stub's output) before the text tokens
(:func:`embed_with_prefix`), and the decode continues after both.
The decode step keeps the reference's shape: each attention layer
attends over the OLD cache plus the new token's column
(``attn_decode_delta``), and the new K/V of all layers land in ONE
stacked write after the loop; each SSM block's state rows are replaced
in place.  The encdec family has its own module (``models/encdec.py``,
which ``models/api.py`` routes it to); here it raises
``NotImplementedError``.

Training (:func:`loss_train`, the reference's ``loss_train``) runs every
learner of a learner-stacked tree (a leading learner axis on every leaf,
the layers' axis second) in one pass: x (L, B, S, d), one batched
product per weight, each kernel called once for all learners
(:func:`forward_train`).  Each layer is recomputed in the backward
(``torch.utils.checkpoint``) when ``cfg.remat`` is set, as the
reference's ``jax.checkpoint``; a moe layer's auxiliary loss is kept,
per learner.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import moe as M
from repro_torch.models import ssm as SM
from repro_torch.models.common import (apply_norm, cross_entropy, linear,
                                       norm_spec, rmsnorm, rope_angles)
from repro_torch.params import ParamSpec

GLOBAL_WINDOW = np.int32(2 ** 30)   # "window" meaning full attention


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
ATTENTION_ONLY = ("dense", "moe", "vlm")
# the logical axes of a stacked KV cache (L, batch, positions, KV, E)
KV_CACHE_AXES = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")


def _require_ported(cfg):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not a family of the decoder-only "
            f"stack (dense, moe, ssm, hybrid, vlm); the encdec family is "
            f"models/encdec.py's")


def _require_attention(cfg):
    """The paged KV cache holds attention keys and values only: the ssm
    family's state is per-slot O(1) and has nothing to page, and the
    hybrid family's per-slot SSM state is refused with it, as the
    reference refuses every family that is not attention-only (dense, moe
    and vlm)."""
    _require_ported(cfg)
    if cfg.family not in ATTENTION_ONLY:
        raise ValueError(f"paged KV cache needs an attention-only family, "
                         f"got {cfg.family}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def layer_param_specs(cfg) -> dict:
    _require_ported(cfg)
    if cfg.family == "ssm":
        return {"ln1": norm_spec(cfg), "ssm": SM.ssm_param_specs(cfg)}
    p = {"ln1": norm_spec(cfg), "attn": A.attn_param_specs(cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = SM.ssm_param_specs(cfg)
    p["ln2"] = norm_spec(cfg)
    if cfg.family == "moe":
        p["moe"] = M.moe_param_specs(cfg)
    else:
        p["mlp"] = F.ffn_param_specs(cfg)
    return p


def _stack(spec_tree, n):
    """Prepend the layer axis.  A lecun weight keeps its own fan-in (the
    first axis of the per-layer shape) as an explicit normal scale: the
    reference's stacked lecun takes its fan-in from the layer axis
    (scale 1/sqrt(L)), which makes random-init attention near one-hot
    (and every ssm projection and conv kernel as large)."""
    if isinstance(spec_tree, dict):
        return {k: _stack(v, n) for k, v in spec_tree.items()}
    ps = spec_tree
    init, scale = ps.init, ps.init_scale
    if init == "lecun":
        init, scale = "normal", float(1.0 / np.sqrt(max(ps.shape[0], 1)))
    return ParamSpec((n,) + tuple(ps.shape), ps.dtype, init, scale,
                     ("layers",) + tuple(ps.axes))


def param_specs(cfg) -> dict:
    d, V = cfg.d_model, cfg.vocab
    p = {
        "embed": ParamSpec((V, d), cfg.param_dtype, "normal", 0.02,
                           ("vocab", "embed")),
        "layers": _stack(layer_param_specs(cfg), cfg.n_layers),
        "final_norm": norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((d, V), cfg.param_dtype, "normal", 0.02,
                                 ("embed", "vocab"))
    return p


def layer_windows(cfg, seq_len: int, *, long_context: bool = False):
    """Per-layer attention window array (n_layers,) int32."""
    w = cfg.window
    if long_context and w == 0:
        w = cfg.window_for_long   # documented sliding-window variant
    if w == 0:
        return np.full((cfg.n_layers,), GLOBAL_WINDOW, np.int32)
    ws = np.full((cfg.n_layers,), w, np.int32)
    for i in cfg.global_attn_layers:
        if i < cfg.n_layers:
            ws[i] = GLOBAL_WINDOW
    return ws


def _rope(cfg, positions):
    """The rotary (sin, cos) every layer shares, or None without RoPE."""
    if cfg.rope_theta <= 0:
        return None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _hybrid_combine(attn_out, ssm_out):
    """Hymba's fusion: each branch's output rmsnormed (no scale), then
    their mean."""
    return 0.5 * (rmsnorm(attn_out) + rmsnorm(ssm_out))


def _ffn(cfg, p, x):
    """The layer's FFN on its normed input: the dense FFN, or the moe
    family's mixture of experts (no auxiliary loss: serving discards it)."""
    h = apply_norm(p["ln2"], x)
    if cfg.family == "moe":
        return M.moe_ffn(cfg, p["moe"], h)
    return F.ffn_apply(cfg, p["mlp"], h)


def _stack_conv(convs):
    return {k: torch.stack([c[k] for c in convs]) for k in convs[0]}


# ---------------------------------------------------------------------------
# Sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward_seq(cfg, params, x, *, collect_cache: bool = False,
                cache_len: int = 0, long_context: bool = False):
    """x (B, S, d) embedded inputs -> (hidden, cache).  Without
    ``collect_cache`` the cache is ().  The dense cache is the stacked
    (k, v), each (L, B, max(S, cache_len), KV, E); the ssm cache is the
    stacked (conv_state {'x', 'B', 'C'}, ssm_state), each with a leading
    L; the hybrid cache is ((k, v), conv_state, ssm_state).  The moe
    family's auxiliary loss is not returned (inference only)."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _forward_seq_ssm(cfg, params, x, collect_cache)
    hybrid = cfg.family == "hybrid"
    B, S, _ = x.shape
    windows = layer_windows(cfg, S, long_context=long_context)
    rope = _rope(cfg, torch.arange(S, device=x.device)[None, :])
    x = x.to(torch.bfloat16)
    ks, vs, convs, hs = [], [], [], []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = apply_norm(p["ln1"], x)
        q, k, v = A.qkv_project(cfg, p["attn"], h, h, rope=rope)
        o = A.out_project(p["attn"], A.attn_prefill(q, k, v,
                                                    window=int(windows[i])))
        if hybrid:
            o_ssm, (conv, h_ssm) = SM.mamba2_seq(cfg, p["ssm"], h)
            o = _hybrid_combine(o, o_ssm).to(x.dtype)
        x = x + o
        if collect_cache:
            k, v = _pad_cache(k, v, cache_len)
            ks.append(k)
            vs.append(v)
            if hybrid:
                convs.append(conv)
                hs.append(h_ssm)
        x = x + _ffn(cfg, p, x)
        x = x.to(torch.bfloat16)
    if not collect_cache:
        return x, ()
    kv = (torch.stack(ks), torch.stack(vs))
    if hybrid:
        return x, (kv, _stack_conv(convs), torch.stack(hs))
    return x, kv


def _forward_seq_ssm(cfg, params, x, collect_cache):
    x = x.to(torch.bfloat16)
    convs, hs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        o, (conv, h_ssm) = SM.mamba2_seq(cfg, p["ssm"],
                                         apply_norm(p["ln1"], x))
        x = (x + o).to(torch.bfloat16)
        if collect_cache:
            convs.append(conv)
            hs.append(h_ssm)
    if not collect_cache:
        return x, ()
    return x, (_stack_conv(convs), torch.stack(hs))


# ---------------------------------------------------------------------------
# Training forward (learner-stacked)
# ---------------------------------------------------------------------------

def unstack_layers(tree, n: int) -> list:
    """A learner-stacked layer tree (every leaf (L, n, ...)) -> n trees of
    (L, ...) views, one per layer.  One ``unbind`` per leaf: its backward
    stacks the layers' gradients once, where slicing each layer out would
    write a whole-leaf gradient per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(1))


def _train_layer(cfg, window, rope, keep, slot, x, p):
    """One layer of :func:`forward_train`: x (L, B, S, d) -> (x', aux
    (L,) f32, zero but in a moe layer)."""
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    h = apply_norm(p["ln1"], x)
    if cfg.family == "ssm":
        return (x + SM.mamba2_seq(cfg, p["ssm"], h)[0]).to(torch.bfloat16), aux
    q, k, v = A.qkv_project(cfg, p["attn"], h, h, rope=rope)
    o = A.out_project(p["attn"], A.attn_prefill(q, k, v, window=window))
    if cfg.family == "hybrid":
        o = _hybrid_combine(o, SM.mamba2_seq(cfg, p["ssm"], h)[0]).to(x.dtype)
    x = x + o
    h = apply_norm(p["ln2"], x)
    if cfg.family == "moe":
        y, aux = M.moe_apply(cfg, p["moe"], h, keep=keep, slot=slot)
    else:
        y = F.ffn_apply(cfg, p["mlp"], h)
    return (x + y).to(torch.bfloat16), aux


def forward_train(cfg, params, x, *, keep=None):
    """The training forward over learner-stacked params: x (L, B, S, d)
    embedded inputs -> (hidden (L, B, S, d) bf16, aux (L,) f32, the moe
    layers' load-balance losses summed; zeros for the other families).
    Each layer runs under ``torch.utils.checkpoint`` (non-reentrant) when
    ``cfg.remat`` is set, so its kernels launch again in the backward.
    ``keep`` holds a moe layer's learner-folded expert weights on the
    card (``moe_dense.fold_experts``) from one call to the next."""
    _require_ported(cfg)
    L, B, S, _ = x.shape
    windows = layer_windows(cfg, S)
    rope = _rope(cfg, torch.arange(S, device=x.device)[None, :])
    x = x.to(torch.bfloat16)
    aux = torch.zeros(L, dtype=torch.float32, device=x.device)
    for i, p in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        body = functools.partial(_train_layer, cfg, int(windows[i]), rope,
                                 keep, i)
        if cfg.remat:
            x, a = checkpoint(body, x, p, use_reentrant=False)
        else:
            x, a = body(x, p)
        aux = aux + a
    return x, aux


def embed_rows(embed, tokens):
    """Each learner's embedding rows of its ``tokens`` in bf16: embed (L,
    V, d), tokens (L, ...) -> (L, ..., d)."""
    lidx = torch.arange(embed.shape[0], device=tokens.device)
    lidx = lidx.reshape((-1,) + (1,) * (tokens.dim() - 1))
    return embed[lidx, tokens.long()].to(torch.bfloat16)


def learner_batch(params, batch, key: str):
    """(params, batch, one): a batch given for one model (``key``'s
    leaf without a learner axis) gets a learner axis of 1 on every leaf
    of both, and ``one`` says to drop it from the loss.  Batch leaves are
    moved to the parameters' device."""
    emb = params["embed"]
    batch = {k: torch.as_tensor(v, device=emb.device) for k, v in
             batch.items()}
    one = batch[key].dim() == (1 if key == "frames" else 0) + 2
    if one:
        params = _map(lambda w: w.unsqueeze(0), params)
        batch = {k: v.unsqueeze(0) for k, v in batch.items()}
    return params, batch, one


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def loss_train(cfg, params, batch, *, keep=None, denominator=None):
    """The reference's ``loss_train``: batch {'tokens', 'labels'} (+
    'patches' for vlm: the loss is over the text positions alone), over
    learner-stacked params and a batch split over learners (tokens (L,
    B, S), patches (L, B, S_patch, d)) -> the (L,) per-learner losses:
    next-token cross entropy, plus ``aux_loss_weight`` times the summed
    load-balance loss for moe.  Params and a batch for one model (tokens
    (B, S)) give the scalar loss.  ``keep``: see :func:`forward_train`.
    ``denominator`` (a rank's term of the global batch's mean, see
    ``cross_entropy``) also weights the load-balance loss by this batch's
    share of the positions."""
    params, batch, one = learner_batch(params, batch, "tokens")
    x = embed_rows(params["embed"], batch["tokens"])
    patches = batch.get("patches")
    if patches is not None:
        x = torch.cat([patches.to(torch.bfloat16), x], dim=2)
    x, aux = forward_train(cfg, params, x, keep=keep)
    x = apply_norm(params["final_norm"], x)
    if patches is not None:
        x = x[:, :, patches.shape[2]:]
    logits = learner_logits(cfg, params, x)
    loss = cross_entropy(logits, batch["labels"], per_learner=True,
                         denominator=denominator)
    if cfg.moe is not None:
        if denominator is not None:
            aux = aux * (batch["labels"][0].numel() / denominator)
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss[0] if one else loss


def learner_logits(cfg, params, x):
    """x (L, B, S, d) -> logits (L, B, S, V) through each learner's tied
    embedding or lm_head."""
    if cfg.tie_embeddings:
        return linear(x, params["embed"].transpose(-1, -2))
    return linear(x, params["lm_head"])


def _pad_cache(k, v, cache_len):
    """Grow prefill K/V to the serving cache length (zero-padded tail)."""
    if cache_len and cache_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, cache_len - k.shape[1])
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return k, v


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()].to(torch.bfloat16)


def embed_with_prefix(cfg, params, tokens, patches=None):
    """The vlm family's early fusion: patch embeddings (B, S_patch, d),
    cast to bf16, then the text tokens' embeddings; the tokens' alone
    without patches."""
    xt = embed_tokens(cfg, params, tokens)
    if patches is None:
        return xt
    return torch.cat([patches.to(torch.bfloat16), xt], dim=1)


def logits_fn(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# Serving: cache layouts, prefill, decode
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int) -> dict:
    """Stacked per-layer decode state: the dense KV cache {'attn': {'k',
    'v'}} (L, batch, cache_len, KV, E) bf16 for the dense and moe
    families, the ssm state {'ssm': {'conv': {'x', 'B', 'C'}, 'h'}} with a
    leading L (cache_len unused: the state is O(1) per slot), or both for
    the hybrid family."""
    _require_ported(cfg)
    specs = {}
    if cfg.family != "ssm":
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                 cfg.head_dim)
        specs["attn"] = {k: ParamSpec(shape, "bfloat16", "zeros",
                                      axes=KV_CACHE_AXES) for k in "kv"}
    if cfg.family in ("ssm", "hybrid"):
        specs["ssm"] = _stack_state(SM.ssm_cache_specs(cfg, batch),
                                    cfg.n_layers)
    return specs


def _stack_state(spec_tree, n):
    if isinstance(spec_tree, dict):
        return {k: _stack_state(v, n) for k, v in spec_tree.items()}
    return spec_tree._replace(shape=(n,) + tuple(spec_tree.shape),
                              axes=("layers",) + tuple(spec_tree.axes))


def page_specs(cfg, n_pages: int, page_size: int) -> dict:
    """Paged KV cache: ONE pool of physical pages shared by every
    in-flight request, k, v (L, n_pages, page_size, KV, E) bf16.
    Attention-only families (dense, moe, vlm): ValueError for the ssm and
    hybrid families."""
    _require_attention(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    axes = ("layers", "pages", "page_pos", "kv_heads", "head_dim")
    return {"attn": {"k": ParamSpec(shape, "bfloat16", "zeros", axes=axes),
                     "v": ParamSpec(shape, "bfloat16", "zeros", axes=axes)}}


def decode_step(cfg, params, cache, tokens, pos: int, *, page_table=None,
                page_size: int = 0, long_context: bool = False):
    """One-token decode.  tokens (B, 1) int, pos the host int position of
    the new token.  Returns (logits (B, 1, V), cache).

    ``page_table`` (B, W) int32 selects the paged layout: cache['attn']
    k/v are page pools (L, n_pages, P, KV, E) and the new column lands in
    the table's page for ``pos`` (attention-only families: ValueError for
    ssm and hybrid).  The cache tensors are written in place — the new K/V
    column once for all layers after the layer loop, the conv windows and
    SSM states replaced whole per layer — and returned.  ``long_context``
    gives a full-attention arch its documented sliding window
    (:func:`layer_windows`)."""
    _require_ported(cfg)
    if page_table is not None:
        _require_attention(cfg)
    if cfg.family == "ssm":
        return _decode_step_ssm(cfg, params, cache, tokens)
    hybrid = cfg.family == "hybrid"
    paged = page_table is not None
    kc, vc = cache["attn"]["k"], cache["attn"]["v"]
    S_cache = page_table.shape[-1] * page_size if paged else kc.shape[2]
    windows = layer_windows(cfg, S_cache, long_context=long_context)
    x = embed_tokens(cfg, params, tokens)
    rope = _rope(cfg, torch.full((tokens.shape[0], 1), int(pos),
                                 device=x.device))
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = apply_norm(p["ln1"], x)
        q, k, v = A.qkv_project(cfg, p["attn"], h, h, rope=rope)
        o = A.out_project(p["attn"], A.attn_decode_delta(
            q, kc[i], vc[i], k, v, pos, window=int(windows[i]),
            page_table=page_table))
        if hybrid:
            o = _hybrid_combine(o, _ssm_step(cfg, p, cache, i, h)).to(x.dtype)
        x = x + o
        x = x + _ffn(cfg, p, x)
        x = x.to(torch.bfloat16)
        k_new.append(k)
        v_new.append(v)
    # ONE stacked write of the new token column per step
    k_new, v_new = torch.stack(k_new), torch.stack(v_new)
    if paged:
        A.write_new_token_paged(kc, k_new, page_table, pos, page_size)
        A.write_new_token_paged(vc, v_new, page_table, pos, page_size)
    else:
        A.write_new_token(kc, k_new, pos)
        A.write_new_token(vc, v_new, pos)
    x = apply_norm(params["final_norm"], x)
    return logits_fn(cfg, params, x), cache


def _ssm_step(cfg, p, cache, i, h):
    """Layer i's Mamba-2 block one token on: its conv window and SSM
    state rows of ``cache['ssm']`` replaced in place; the block's output
    (B, 1, d)."""
    st = cache["ssm"]
    conv_i = {k: v[i] for k, v in st["conv"].items()}
    o, (conv, h_ssm) = SM.mamba2_step(cfg, p["ssm"], h, conv_i, st["h"][i])
    for k, v in conv.items():
        conv_i[k].copy_(v)
    st["h"][i].copy_(h_ssm)
    return o


def _decode_step_ssm(cfg, params, cache, tokens):
    """The ssm family's step: position-free, so ``pos`` plays no part."""
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        o = _ssm_step(cfg, p, cache, i, apply_norm(p["ln1"], x))
        x = (x + o).to(torch.bfloat16)
    x = apply_norm(params["final_norm"], x)
    return logits_fn(cfg, params, x), cache


def prefill(cfg, params, tokens, *, cache_len: int = 0, patches=None,
            long_context: bool = False):
    """Full-context forward of tokens (B, S), after ``patches`` (B,
    S_patch, d) where given (:func:`embed_with_prefix`) -> (last-token
    logits (B, 1, V), the decode cache): {'attn': {'k', 'v'}} of length
    max(S_patch + S, cache_len) for the dense, moe and vlm families,
    {'ssm': {'conv', 'h'}} for the ssm family, both for the hybrid
    family."""
    x = embed_with_prefix(cfg, params, tokens, patches)
    cache_len = cache_len or x.shape[1]
    x, caches = forward_seq(cfg, params, x, collect_cache=True,
                            cache_len=cache_len, long_context=long_context)
    x = apply_norm(params["final_norm"], x)
    logits = logits_fn(cfg, params, x[:, -1:, :])
    if cfg.family == "ssm":
        conv, h = caches
        return logits, {"ssm": {"conv": conv, "h": h}}
    if cfg.family == "hybrid":
        (k, v), conv, h = caches
        return logits, {"attn": {"k": k, "v": v},
                        "ssm": {"conv": conv, "h": h}}
    k, v = caches
    return logits, {"attn": {"k": k, "v": v}}
