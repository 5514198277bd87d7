"""Whisper-style encoder-decoder transformer: the encdec family — the port
of ``repro.models.encdec`` (parameter specs, the encoder, the
teacher-forced decoder, prefill, the one-token decode step and the
training loss over learner-stacked params, :func:`loss_train`).

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, S_enc,
d_model).  Both stacks add sinusoidal positions
(:func:`~repro_torch.models.common.sinusoidal_positions`, f32, cast to
bf16 before the add), the reference's stand-in for whisper's learned
decoder positions.  Layers are stacked along a leading axis, walked by a
Python loop.  Casts follow the reference:
frames to bf16 before the positions, each layer's residual stream bf16.

* ``encode`` — non-causal self-attention layers (``attention.
  attn_prefill(causal=False)``: K11 on the card, any S_enc), each with
  its GELU FFN, then the final norm.
* ``decode_seq`` — causal self-attention, then cross-attention over the
  encoder output (non-causal K11, Sq = the tokens, Sk = S_enc), then the
  FFN, per layer; with ``collect_cache`` each layer's self K/V (padded to
  ``cache_len``) and its cross K/V (the encoder output's projections).
* ``prefill`` — both, the last token's logits (tied embedding) and the
  caches {'self': {'k', 'v'}, 'cross': {'k', 'v'}}, each (L, B, S, KV,
  E) bf16.
* ``decode_step`` — the self-attention takes the delta form the decoder-
  only stack takes (``attention.attn_decode_delta``: the old cache plus
  the new token's column, K7's delta variant on the card) and the new
  K/V of every layer land in ONE stacked write after the layer loop,
  where the reference writes each layer's cache first and attends over
  it (``update_cache`` + ``attn_decode``): the same function.  The
  cross-attention projects q alone (with its bias, as the reference does)
  and reads the whole cross cache at ``pos = S_enc - 1``
  (``attention.attn_decode``: K7's canonical variant over all S_enc
  rows); the cross cache is never written.

No server runs this family (the reference's ``Server`` asserts it away);
its entry points are ``models.api.Model.prefill_fn`` / ``decode_fn``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import transformer as TF
from repro_torch.models.common import (apply_norm, cross_entropy, linear,
                                       norm_spec, sinusoidal_positions)
from repro_torch.models.transformer import (_layer, _pad_cache, _stack,
                                            embed_rows, learner_batch,
                                            unstack_layers)
from repro_torch.params import ParamSpec


def enc_layer_specs(cfg) -> dict:
    return {"ln1": norm_spec(cfg), "attn": A.attn_param_specs(cfg),
            "ln2": norm_spec(cfg), "mlp": F.ffn_param_specs(cfg)}


def dec_layer_specs(cfg) -> dict:
    return {"ln1": norm_spec(cfg), "self_attn": A.attn_param_specs(cfg),
            "lnx": norm_spec(cfg), "cross_attn": A.attn_param_specs(cfg),
            "ln2": norm_spec(cfg), "mlp": F.ffn_param_specs(cfg)}


def param_specs(cfg) -> dict:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.param_dtype,
                           "normal", 0.02, ("vocab", "embed")),
        "enc_layers": _stack(enc_layer_specs(cfg), cfg.n_enc_layers),
        "enc_norm": norm_spec(cfg),
        "dec_layers": _stack(dec_layer_specs(cfg), cfg.n_layers),
        "dec_norm": norm_spec(cfg),
    }


def _add_positions(x):
    """x (..., S, d) + the sinusoids of positions 0..S-1 in x's dtype."""
    pos = torch.arange(x.shape[-2], device=x.device)
    return x + sinusoidal_positions(pos, x.shape[-1]).to(x.dtype)


def _layers(tree, n: int, learners: bool) -> list:
    """The n layers of a stacked tree: (L, ...) views of a learner-stacked
    one, else the layer slices."""
    if learners:
        return unstack_layers(tree, n)
    return [_layer(tree, i) for i in range(n)]


def _walk(body, x, layers, *args, remat: bool):
    """x through ``body(x, p, *args)`` for each layer p, each recomputed
    in the backward (``torch.utils.checkpoint``) under ``remat``."""
    for p in layers:
        x = (checkpoint(body, x, p, *args, use_reentrant=False) if remat
             else body(x, p, *args))
    return x


def _enc_block(cfg, x, p):
    h = apply_norm(p["ln1"], x)
    q, k, v = A.qkv_project(cfg, p["attn"], h, h)
    x = x + A.out_project(p["attn"], A.attn_prefill(q, k, v, causal=False))
    x = x + F.ffn_apply(cfg, p["mlp"], apply_norm(p["ln2"], x))
    return x.to(torch.bfloat16)


def _dec_block(cfg, x, p, enc_out):
    """One decoder layer -> (x', (k, v, ck, cv)): its self K/V and its
    cross K/V (the encoder output's projections)."""
    h = apply_norm(p["ln1"], x)
    q, k, v = A.qkv_project(cfg, p["self_attn"], h, h)
    x = x + A.out_project(p["self_attn"], A.attn_prefill(q, k, v))
    h = apply_norm(p["lnx"], x)
    q, ck, cv = A.qkv_project(cfg, p["cross_attn"], h, enc_out)
    x = x + A.out_project(p["cross_attn"],
                          A.attn_prefill(q, ck, cv, causal=False))
    x = x + F.ffn_apply(cfg, p["mlp"], apply_norm(p["ln2"], x))
    return x.to(torch.bfloat16), (k, v, ck, cv)


def encode(cfg, params, frames, *, remat: bool = False):
    """frames (B, S_enc, d) stub frame embeddings -> (B, S_enc, d) bf16;
    over learner-stacked params, frames (L, B, S_enc, d) -> (L, B, S_enc,
    d).  ``remat`` recomputes each layer in the backward."""
    x = _add_positions(frames.to(torch.bfloat16))
    layers = _layers(params["enc_layers"], cfg.n_enc_layers,
                     frames.dim() == 4)
    x = _walk(functools.partial(_enc_block, cfg), x, layers, remat=remat)
    return apply_norm(params["enc_norm"], x)


def decode_seq(cfg, params, tokens, enc_out, *, collect_cache: bool = False,
               cache_len: int = 0):
    """Teacher-forced decoder over tokens (B, S) against ``enc_out`` ->
    (hidden (B, S, d), caches).  Without ``collect_cache`` the caches are
    (); with it ((k, v), (ck, cv)), each stacked over the layers: the self
    K/V (L, B, max(S, cache_len), KV, E), the cross K/V (L, B, S_enc, KV,
    E)."""
    x = _add_positions(params["embed"][tokens.long()].to(torch.bfloat16))
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        x, (k, v, ck, cv) = _dec_block(cfg, x, _layer(params["dec_layers"],
                                                      i), enc_out)
        if collect_cache:
            k, v = _pad_cache(k, v, cache_len)
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
    x = apply_norm(params["dec_norm"], x)
    if not collect_cache:
        return x, ()
    return x, ((torch.stack(ks), torch.stack(vs)),
               (torch.stack(cks), torch.stack(cvs)))


def loss_train(cfg, params, batch, *, denominator=None):
    """The reference's ``loss_train``: encode ``frames``, the teacher-
    forced decoder over ``tokens``, tied logits, cross entropy against
    ``labels``.  Over learner-stacked params and a batch split over
    learners (frames (L, B, S_enc, d), tokens (L, B, S)) -> the (L,)
    per-learner losses; for one model (frames (B, S_enc, d)) the scalar.
    Every encoder layer is recomputed in the backward (the reference's
    encoder is ``jax.checkpoint``-ed whatever the config says), every
    decoder layer when ``cfg.remat`` is set.  ``denominator``: see
    ``cross_entropy``."""
    params, batch, one = learner_batch(params, batch, "frames")
    enc_out = encode(cfg, params, batch["frames"], remat=True)
    x = _add_positions(embed_rows(params["embed"], batch["tokens"]))
    x = _walk(lambda x, p, e: _dec_block(cfg, x, p, e)[0], x,
              unstack_layers(params["dec_layers"], cfg.n_layers), enc_out,
              remat=cfg.remat)
    x = apply_norm(params["dec_norm"], x)
    logits = linear(x, params["embed"].transpose(-1, -2))
    loss = cross_entropy(logits, batch["labels"], per_learner=True,
                         denominator=denominator)
    return loss[0] if one else loss


def cache_specs(cfg, batch: int, cache_len: int, enc_len: int) -> dict:
    """The decode state: {'self': {'k', 'v'}} of ``cache_len`` positions
    and {'cross': {'k', 'v'}} of ``enc_len`` encoder frames, each (L,
    batch, S, KV, E) bf16."""
    def kv(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {k: ParamSpec(shape, "bfloat16", "zeros",
                             axes=TF.KV_CACHE_AXES) for k in "kv"}
    return {"self": kv(cache_len), "cross": kv(enc_len)}


def prefill(cfg, params, frames, tokens, *, cache_len: int = 0):
    """Encode ``frames`` (B, S_enc, d), run the decoder over ``tokens``
    (B, S) -> (last-token logits (B, 1, V), the caches of
    :func:`cache_specs`, the self cache max(S, cache_len) long)."""
    enc_out = encode(cfg, params, frames)
    x, ((k, v), (ck, cv)) = decode_seq(
        cfg, params, tokens, enc_out, collect_cache=True,
        cache_len=cache_len or tokens.shape[1])
    logits = x[:, -1:, :] @ params["embed"].T
    return logits, {"self": {"k": k, "v": v}, "cross": {"k": ck, "v": cv}}


def _cross_q(p, h):
    """The cross-attention's q alone (the cached K/V are the encoder
    output's): h (B, 1, d) -> (B, 1, H, E), its bias added in f32."""
    B, S, d = h.shape
    H, E = p["wq"].shape[1], p["wq"].shape[2]
    q = (h @ p["wq"].reshape(d, H * E)).view(B, S, H, E)
    if "bq" in p:
        q = (q.float() + p["bq"]).to(q.dtype)
    return q


def decode_step(cfg, params, cache, tokens, pos: int):
    """One decoder token: tokens (B, 1) int at the host int position
    ``pos`` -> (logits (B, 1, V), cache).  The self cache's column ``pos``
    is written in place, once for all layers, after the layer loop; the
    cross cache is only read."""
    x = params["embed"][tokens.long()].to(torch.bfloat16)
    posv = torch.full((tokens.shape[0], 1), int(pos), device=x.device)
    x = x + sinusoidal_positions(posv, cfg.d_model).to(x.dtype)
    kc, vc = cache["self"]["k"], cache["self"]["v"]
    ckc, cvc = cache["cross"]["k"], cache["cross"]["v"]
    last = ckc.shape[2] - 1
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["dec_layers"], i)
        h = apply_norm(p["ln1"], x)
        q, k, v = A.qkv_project(cfg, p["self_attn"], h, h)
        x = x + A.out_project(p["self_attn"], A.attn_decode_delta(
            q, kc[i], vc[i], k, v, pos))
        q = _cross_q(p["cross_attn"], apply_norm(p["lnx"], x))
        x = x + A.out_project(p["cross_attn"],
                              A.attn_decode(q, ckc[i], cvc[i], last))
        x = x + F.ffn_apply(cfg, p["mlp"], apply_norm(p["ln2"], x))
        x = x.to(torch.bfloat16)
        k_new.append(k)
        v_new.append(v)
    A.write_new_token(kc, torch.stack(k_new), pos)
    A.write_new_token(vc, torch.stack(v_new), pos)
    x = apply_norm(params["dec_norm"], x)
    return x @ params["embed"].T, cache
