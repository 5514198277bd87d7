"""Batched CTC prefix beam search in PyTorch — the port of
``repro.decode.beam`` (docs/decoding.md has the contract).

Per prefix the beam carries two log scores, ``p_b`` (alignments ending
in blank) and ``p_nb`` (ending in the prefix's last token), combined by
the ``max`` (Viterbi) or ``sum`` (log-semiring) merge.  The per-frame
step expands K stays + K·(V-1) extends, merges duplicate prefixes via a
(K x K) check on (length, rolling hash, last token), and selects the top
K by K argmax passes with first-index ties.  The plain step functions
here are the oracle of the CUDA kernel in ``decode/kernel.py``, and the
CPU path of its wrapper; the state update around them is torch ops on
either device, as it is jnp in the reference.

Streaming: ``state = init_state(...)``, then repeated
``decode_chunk(state, logits_chunk, lengths)``, then ``finalize``; rows
whose frame counter ``t`` has reached their length are frozen, so chunked
and one-shot decodes are bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

NEG = -1e30
HASH_P = 1_000_003        # rolling-hash multiplier (int32 wraparound)


def _merge_fn(semiring: str):
    if semiring == "max":
        return torch.maximum
    if semiring == "sum":
        return torch.logaddexp
    raise ValueError(f"semiring must be 'max' or 'sum', got {semiring!r}")


def _reduce_fn(semiring: str):
    if semiring == "max":
        return lambda x, dim: torch.amax(x, dim=dim)
    if semiring == "sum":
        return lambda x, dim: torch.logsumexp(x, dim=dim)
    raise ValueError(f"semiring must be 'max' or 'sum', got {semiring!r}")


def _hash_step(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``h * HASH_P + c`` with the reference's int32 wraparound (computed
    in int64, then wrapped, so no signed overflow happens)."""
    v = (h.to(torch.int64) * HASH_P + c.to(torch.int64)) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


class BeamState(NamedTuple):
    """Carry of the streaming decode."""

    tokens: torch.Tensor     # (B, K, U) i32, -1 padded
    lens: torch.Tensor       # (B, K) i32 prefix lengths
    last: torch.Tensor       # (B, K) i32 last token (-1 = empty prefix)
    phash: torch.Tensor      # (B, K) i32 rolling prefix hash
    p_b: torch.Tensor        # (B, K) f32 log score, alignments ending blank
    p_nb: torch.Tensor       # (B, K) f32 log score, ending non-blank
    t: torch.Tensor          # (B,) i32 frames consumed (freeze counter)


def init_state(batch: int, beam: int, max_len: int, device) -> BeamState:
    """Fresh beams: slot 0 holds the empty prefix (p_b = 0), the rest are
    NEG placeholders that real candidates displace on the first frame."""
    i32 = dict(dtype=torch.int32, device=device)
    p_b = torch.full((batch, beam), NEG, dtype=torch.float32, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        tokens=torch.full((batch, beam, max_len), -1, **i32),
        lens=torch.zeros((batch, beam), **i32),
        last=torch.full((batch, beam), -1, **i32),
        phash=torch.zeros((batch, beam), **i32),
        p_b=p_b,
        p_nb=torch.full((batch, beam), NEG, dtype=torch.float32,
                        device=device),
        t=torch.zeros((batch,), **i32),
    )


def _rows(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def gather_rows(state: BeamState, idx) -> BeamState:
    """Snapshot beam rows ``idx`` (N,) as a BeamState with batch N (the
    serving preemption snapshot)."""
    idx = _rows(idx, state.t.device)
    return BeamState(*(arr[idx] for arr in state))


def scatter_rows(state: BeamState, rows: BeamState, idx) -> BeamState:
    """Write snapshot ``rows`` (batch N) back into rows ``idx`` of
    ``state``; gather-then-scatter through the same indices is the
    identity."""
    idx = _rows(idx, state.t.device)
    return BeamState(*(
        arr.index_copy(0, idx, torch.as_tensor(src).to(arr.device,
                                                       arr.dtype))
        for arr, src in zip(state, rows)))


def reset_rows(state: BeamState, mask: torch.Tensor) -> BeamState:
    """Re-arm rows where ``mask`` (B,) is True (serving slot admission)."""
    B, K, U = state.tokens.shape
    fresh = init_state(B, K, U, state.t.device)
    m2 = mask[:, None]
    return BeamState(
        tokens=torch.where(mask[:, None, None], fresh.tokens, state.tokens),
        lens=torch.where(m2, fresh.lens, state.lens),
        last=torch.where(m2, fresh.last, state.last),
        phash=torch.where(m2, fresh.phash, state.phash),
        p_b=torch.where(m2, fresh.p_b, state.p_b),
        p_nb=torch.where(m2, fresh.p_nb, state.p_nb),
        t=torch.where(mask, fresh.t, state.t),
    )


# ---------------------------------------------------------------------------
# per-frame step: candidate expansion + duplicate merge + top-K (plain)
# ---------------------------------------------------------------------------

def _stay_scores(logp, p_b, p_nb, last, blank, merge):
    tot = merge(p_b, p_nb)                                       # (B, K)
    stay_pb = tot + logp[:, blank][:, None]
    lp_last = torch.gather(logp, 1, last.clamp(min=0).long())
    stay_pnb = torch.where(last >= 0, p_nb + lp_last, NEG)
    return tot, stay_pb, lp_last, stay_pnb


def _match(phash, plen, last):
    """match[b, k, j]: parent k's extend by last[j] is in-beam prefix j."""
    return ((plen[:, None, :] == plen[:, :, None] + 1)
            & (phash[:, None, :] == _hash_step(phash[:, :, None],
                                               last[:, None, :]))
            & (last[:, None, :] >= 0))


def _top_k_passes(cand: torch.Tensor, K: int) -> torch.Tensor:
    """K argmax passes, first index on ties, each selected index stamped to
    NEG (not removed) for the later passes."""
    col_ids = torch.arange(cand.shape[1], device=cand.device)[None, :]
    sels, work = [], cand
    for _ in range(K):
        best = torch.argmax(work, dim=1)
        sels.append(best)
        work = torch.where(col_ids == best[:, None], NEG, work)
    return torch.stack(sels, dim=1)                              # int64


def frame_step_scores(logp, p_b, p_nb, last, phash, plen, *, blank: int,
                      max_len: int, semiring: str):
    """One frame of prefix beam search, batched (``beam.py:166`` of the
    reference, op for op).

    logp (B, V) f32 log-softmax of the frame; p_b/p_nb (B, K) f32;
    last/phash/plen (B, K) i32.  Returns ``(sel, new_pb, new_pnb)``:
    ``sel`` (B, K) i32 indexes the flattened (K*V,) candidate grid —
    ``k*V + c`` extends prefix k with c, except c == blank, which is
    "prefix k stays" — best first."""
    B, V = logp.shape
    K = p_b.shape[1]
    merge = _merge_fn(semiring)
    reduce_ = _reduce_fn(semiring)
    tot, stay_pb, _, stay_pnb = _stay_scores(logp, p_b, p_nb, last, blank,
                                             merge)

    c_ids = torch.arange(V, device=logp.device)[None, None, :]
    base = torch.where(c_ids == last[:, :, None], p_b[:, :, None],
                       tot[:, :, None])
    ext = base + logp[:, None, :]                                # (B, K, V)
    ext = torch.where(c_ids == blank, NEG, ext)
    ext = torch.where(plen[:, :, None] >= max_len, NEG, ext)     # U cap

    match = _match(phash, plen, last)                            # (B, K, K)
    idx = last.clamp(min=0)[:, None, :].expand(B, K, K).long()
    e = torch.gather(ext, 2, idx)              # e[b,k,j] = ext[b,k,last[j]]
    contrib = reduce_(torch.where(match, e, NEG), 1)             # (B, K)
    stay_pnb = merge(stay_pnb, contrib)
    for j in range(K):                           # kill the merged extends
        cj = last[:, j].clamp(min=0)
        hit = match[:, :, j][:, :, None] & (c_ids == cj[:, None, None])
        ext = torch.where(hit, NEG, ext)

    stay_tot = merge(stay_pb, stay_pnb)
    cand = torch.where(c_ids == blank, stay_tot[:, :, None], ext)
    sel = _top_k_passes(cand.reshape(B, K * V), K)
    ext_flat = ext.reshape(B, K * V)

    parent = sel // V
    is_stay = (sel % V) == blank
    new_pb = torch.where(is_stay, torch.gather(stay_pb, 1, parent), NEG)
    new_pnb = torch.where(is_stay, torch.gather(stay_pnb, 1, parent),
                          torch.gather(ext_flat, 1, sel))
    return sel.to(torch.int32), new_pb, new_pnb


def topc_scores(logp, C: int):
    """Per-row top-C of (B, V) log-probs by C argmax passes (first index on
    ties); values gathered from the original row.  Returns
    ``(vals (B, C) f32, idx (B, C) int64)``."""
    idx = _top_k_passes(logp, C)
    return torch.gather(logp, 1, idx), idx


def frame_step_scores_topc(logp, p_b, p_nb, last, phash, plen, *,
                           blank: int, max_len: int, semiring: str,
                           topc: int):
    """Top-C vocab-pruned frame step (``beam.py:261`` of the reference):
    the contract of :func:`frame_step_scores` with a (K, C) extend grid
    over the frame's top-C tokens; stay and merge terms are rebuilt from
    scalars, so pruning only ever drops extension candidates."""
    B, V = logp.shape
    K = p_b.shape[1]
    C = topc
    merge = _merge_fn(semiring)
    reduce_ = _reduce_fn(semiring)

    vals, idx = topc_scores(logp, C)                             # (B, C)
    tot, stay_pb, lp_last, stay_pnb = _stay_scores(logp, p_b, p_nb, last,
                                                   blank, merge)

    idx3 = idx[:, None, :]                                       # (B, 1, C)
    base = torch.where(idx3 == last[:, :, None], p_b[:, :, None],
                       tot[:, :, None])
    ext = base + vals[:, None, :]                                # (B, K, C)
    ext = torch.where(idx3 == blank, NEG, ext)
    ext = torch.where(plen[:, :, None] >= max_len, NEG, ext)     # U cap

    match = _match(phash, plen, last)
    base_kj = torch.where(last[:, None, :] == last[:, :, None],
                          p_b[:, :, None], tot[:, :, None])      # (B, K, K)
    e = base_kj + lp_last[:, None, :]
    e = torch.where(plen[:, :, None] >= max_len, NEG, e)
    contrib = reduce_(torch.where(match, e, NEG), 1)             # (B, K)
    stay_pnb = merge(stay_pnb, contrib)
    for j in range(K):                           # kill the merged extends
        hit = (match[:, :, j][:, :, None]
               & (idx3 == last[:, j][:, None, None]))
        ext = torch.where(hit, NEG, ext)

    stay_tot = merge(stay_pb, stay_pnb)
    cand = torch.cat([stay_tot[:, :, None], ext], dim=2)
    sel_c = _top_k_passes(cand.reshape(B, K * (C + 1)), K)
    ext_flat = ext.reshape(B, K * C)

    # map back to the K*V convention so apply_selection is shared
    parent = sel_c // (C + 1)
    within = sel_c % (C + 1)
    is_stay = within == 0
    q = (within - 1).clamp(0, C - 1)
    c = torch.where(is_stay, blank, torch.gather(idx, 1, q))
    sel = parent * V + c
    new_pb = torch.where(is_stay, torch.gather(stay_pb, 1, parent), NEG)
    new_pnb = torch.where(is_stay, torch.gather(stay_pnb, 1, parent),
                          torch.gather(ext_flat, 1, parent * C + q))
    return sel.to(torch.int32), new_pb, new_pnb


def apply_selection(state: BeamState, sel, new_pb, new_pnb, *, blank: int,
                    vocab: int) -> BeamState:
    """Materialise the selected candidates into the next beam state (token
    append, hash and length bookkeeping)."""
    B, K, U = state.tokens.shape
    sel = sel.long()
    parent = sel // vocab
    c = (sel % vocab).to(torch.int32)
    is_stay = c == blank

    tokens = torch.gather(state.tokens, 1, parent[:, :, None].expand(B, K, U))
    plen = torch.gather(state.lens, 1, parent)
    phash = torch.gather(state.phash, 1, parent)
    plast = torch.gather(state.last, 1, parent)

    u_ids = torch.arange(U, device=sel.device)[None, None, :]
    put = (~is_stay)[:, :, None] & (u_ids == plen[:, :, None])
    tokens = torch.where(put, c[:, :, None], tokens)
    return state._replace(
        tokens=tokens,
        lens=plen + (~is_stay).to(torch.int32),
        last=torch.where(is_stay, plast, c),
        phash=torch.where(is_stay, phash, _hash_step(phash, c)),
        p_b=new_pb,
        p_nb=new_pnb,
    )


# ---------------------------------------------------------------------------
# chunked decode (the streaming carry) and one-shot search
# ---------------------------------------------------------------------------

def decode_chunk(state: BeamState, logits, lengths=None, *, blank: int = 0,
                 semiring: str = "max", topc: int = 0) -> BeamState:
    """Advance the beams over a chunk of frames.

    logits (B, Tc, V) raw (pre-softmax); ``lengths`` (B,) counts TOTAL
    valid frames from stream start — rows whose ``state.t`` has reached
    their length are frozen.  Each frame's step runs in
    ``decode.kernel.beam_frame_step`` (the CUDA kernel on the card, the
    plain step on the CPU).  ``topc`` > 0 prunes the extend grid to the
    frame's top-C tokens; 0 or >= V runs unpruned."""
    from repro_torch.decode.kernel import beam_frame_step

    B, Tc, V = logits.shape
    K = state.p_b.shape[1]
    U = state.tokens.shape[2]
    if K > V:
        raise ValueError(f"beam width {K} exceeds vocab {V}")
    # frame-major, so each frame's (B, V) slice is contiguous
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    logp = logp.contiguous()
    topc = 0 if topc >= V else topc
    for f in range(Tc):
        st = state
        sel, npb, npnb = beam_frame_step(
            logp[f], st.p_b, st.p_nb, st.last, st.phash, st.lens,
            blank=blank, max_len=U, semiring=semiring, topc=topc)
        new = apply_selection(st, sel, npb, npnb, blank=blank, vocab=V)
        if lengths is None:
            state = new._replace(t=st.t + 1)
            continue
        valid = st.t < lengths                                   # (B,)
        v2, v3 = valid[:, None], valid[:, None, None]
        state = BeamState(
            tokens=torch.where(v3, new.tokens, st.tokens),
            lens=torch.where(v2, new.lens, st.lens),
            last=torch.where(v2, new.last, st.last),
            phash=torch.where(v2, new.phash, st.phash),
            p_b=torch.where(v2, new.p_b, st.p_b),
            p_nb=torch.where(v2, new.p_nb, st.p_nb),
            t=torch.where(valid, st.t + 1, st.t),
        )
    return state


def beam_occupancy(state: BeamState) -> torch.Tensor:
    """(B,) fraction of beam slots holding a live prefix (finite score)."""
    tot = torch.maximum(state.p_b, state.p_nb)
    return (tot > NEG / 2).float().mean(dim=1)


def finalize(state: BeamState, *, len_norm: float = 0.0,
             semiring: str = "max"):
    """Best hypothesis per row: ``(tokens (B, U) i32 -1-padded, lens (B,),
    scores (B,))``; ``len_norm`` = a ranks by ``score / max(len, 1)**a``."""
    U = state.tokens.shape[2]
    tot = _merge_fn(semiring)(state.p_b, state.p_nb)
    score = tot
    if len_norm:
        score = tot / state.lens.clamp(min=1).float() ** len_norm
    best = torch.argmax(score, dim=1)
    tokens = state.tokens[torch.arange(len(best), device=best.device), best]
    lens = torch.gather(state.lens, 1, best[:, None])[:, 0]
    sc = torch.gather(score, 1, best[:, None])[:, 0]
    u_ids = torch.arange(U, device=tokens.device)[None, :]
    tokens = torch.where(u_ids < lens[:, None], tokens, -1)
    return tokens, lens, sc


def beam_search(logits, lengths=None, *, beam: int = 8, blank: int = 0,
                semiring: str = "max", len_norm: float = 0.0,
                max_len: int = None, topc: int = 0, device=None):
    """One-shot batched prefix beam search over (B, T, V) logits on
    ``device`` (default: the CUDA card).  Returns ``(tokens (B, U) i32
    -1-padded, lens (B,), scores (B,))``."""
    dev = resolve_device(device)
    logits = torch.as_tensor(logits, device=dev)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    B, T, _ = logits.shape
    U = max_len if max_len is not None else T
    state = init_state(B, beam, U, dev)
    state = decode_chunk(state, logits, lengths, blank=blank,
                         semiring=semiring, topc=topc)
    return finalize(state, len_norm=len_norm, semiring=semiring)


def beam_decode(logits, lengths=None, **kw):
    """:func:`beam_search` with list-of-int-lists output, mirroring
    ``eval.metrics.greedy_ctc_decode`` for drop-in TER scoring."""
    tokens, lens, _ = beam_search(logits, lengths, **kw)
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    return [list(map(int, row[:n])) for row, n in zip(tokens, lens)]
