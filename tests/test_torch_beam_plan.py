"""The launch plan of the CTC beam frame step (K5 port,
``decode.kernel.beam_slices``) and the selection it runs on the card,
emulated on the CPU: each row cut into S slices of a cluster, each slice's
tokens dealt to 512 threads in 16 warps, a threshold tau from the warps'
best candidates, the candidates at or above it ranked (or, past 512 of
them, each warp's best K merged), CTA 0's merge of every slice's best K
and the reference's stamp-to-NEG rule applied to the merged order.
``_twin`` reproduces ``sel`` of ``beam.frame_step_scores`` (and the top-C
tokens of ``beam.topc_scores``) bit for bit: ties across slice bounds,
merge kills in another slice than their parent's best, fewer live
candidates than K, K = 16, V not a multiple of S.  It also holds the
kernel's shortcut: for every token but blank and the prefixes' last
tokens, candidate (k, c) is NEG for a capped parent and tot[k] + logp[c]
otherwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.decode import beam as DB  # noqa: E402
from repro_torch.decode import kernel as DK  # noqa: E402

THREADS, NWARPS, CAP = 512, 16, 512
NEG = float(np.float32(DB.NEG))     # as the f32 grid holds it


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("B,V,n_sm,want", [
    (4, 32000, 132, 8),        # serve: 32 CTAs
    (8, 32000, 132, 8),        # evaluate: 64 CTAs
    (32, 32000, 132, 4),       # B S within one wave of SMs
    (200, 32000, 132, 1),      # more rows than SMs
    (1, 300, 132, 1),          # a slice holds at least 512 tokens
    (2, 1500, 132, 2),
    (1, 100000, 132, 8),
])
def test_beam_slices(B, V, n_sm, want):
    S = DK.beam_slices(B, V, n_sm)
    assert S == want
    assert 1 <= S <= DK.BEAM_MAX_SLICES
    assert B * S <= n_sm or S == 1
    assert S == 1 or V // S >= DK.BEAM_MIN_SLICE


@pytest.mark.parametrize("V,S", [(32000, 8), (4097, 3), (17, 8), (9, 1)])
def test_beam_bounds_cover_the_row(V, S):
    bounds = DK.beam_bounds(V, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    widths = [hi - lo for lo, hi in bounds]
    assert max(widths) - min(widths) <= 1 and min(widths) >= 1


def test_smem_fits_at_the_served_shapes():
    """K = 8, V = 32000: the served slices stay within the wrapper's
    budget, and one CTA a row (the parent's layout) did too."""
    for topc in (0, 16):
        for S in (1, 8):
            assert DK.smem_bytes(8, 32000, topc, S) <= DK.SMEM_BYTES
    assert DK.smem_bytes(8, 32000, 0, 8) == 4 * 4000
    assert DK.smem_bytes(16, 60000, 0, 1) > DK.SMEM_BYTES   # a slice needed


# ------------------------------------------------------------- the twin

def _key(e):
    """The kernel's order: value desc, index asc."""
    return (-e[0], e[1])


def _grid(logp, p_b, p_nb, last, phash, plen, *, blank, max_len):
    """The (B, K, V) candidate grid of ``frame_step_scores`` (max semiring,
    its own lines) and the scalars of the kernel's shortcut."""
    B, V = logp.shape
    K = p_b.shape[1]
    tot, stay_pb, _, stay_pnb = DB._stay_scores(logp, p_b, p_nb, last, blank,
                                                torch.maximum)
    c_ids = torch.arange(V)[None, None, :]
    base = torch.where(c_ids == last[:, :, None], p_b[:, :, None],
                       tot[:, :, None])
    ext = base + logp[:, None, :]
    ext = torch.where(c_ids == blank, NEG, ext)
    ext = torch.where(plen[:, :, None] >= max_len, NEG, ext)
    match = DB._match(phash, plen, last)
    idx = last.clamp(min=0)[:, None, :].expand(B, K, K).long()
    e = torch.gather(ext, 2, idx)
    contrib = torch.amax(torch.where(match, e, NEG), 1)
    stay_pnb = torch.maximum(stay_pnb, contrib)
    for j in range(K):
        cj = last[:, j].clamp(min=0)
        hit = match[:, :, j][:, :, None] & (c_ids == cj[:, None, None])
        ext = torch.where(hit, NEG, ext)
    stay_tot = torch.maximum(stay_pb, stay_pnb)
    cand = torch.where(c_ids == blank, stay_tot[:, :, None], ext)
    cap = plen >= max_len
    return cand, tot, cap, match


def _slice_lists(values, S, n, threshold, taken=None):
    """values: (V,) list of per-token candidate lists [(v, i), ...].  Each
    slice's tokens dealt to THREADS threads (token j of the slice to
    thread j % THREADS, so warp (j % THREADS) // 32), as the kernel does:
    with ``threshold`` tau is the n-th best of the 16 warps' best (else
    -inf); the candidates at or above tau, when at most CAP, are ranked
    and the best n kept; past CAP each warp keeps its best n and the 16
    lists are merged.  Returns each slice's list; ``taken`` collects which
    way each slice went."""
    V = len(values)
    lists = []
    for lo, hi in DK.beam_bounds(V, S):
        warps = [[] for _ in range(NWARPS)]
        for j in range(hi - lo):
            warps[(j % THREADS) // 32].extend(values[lo + j])
        maxima = [min(w, key=_key) if w else (-np.inf, 2 ** 31 - 1)
                  for w in warps]
        ranked = sorted(maxima, key=_key)
        tau = min(v for v, _ in ranked[:n]) if threshold else -np.inf
        above = [e for w in warps for e in w if e[0] >= tau]
        if len(above) <= CAP:
            lists.append(sorted(above, key=_key)[:n])
        else:
            heads = [sorted((e for e in w if e[0] >= tau), key=_key)[:n]
                     for w in warps]
            lists.append(sorted((e for h in heads for e in h),
                                key=_key)[:n])
        if taken is not None:
            taken.append(len(above) <= CAP)
    return lists


def _stamp(order, n):
    """The reference's stamped passes on a merged distinct order."""
    vals = [v for v, _ in order[:n]]
    sel = [i for _, i in order[:n]]
    live = [v > NEG for v in vals] + [False]
    m = live.index(False)
    if m < n:
        w = sel[0]
        if m > 0:
            mn = min(sel[:m])
            w = min(mn, sel[m]) if vals[m] == NEG else mn
        sel[m:] = [w] * (n - m)
    return sel


def _twin(logp, p_b, p_nb, last, phash, plen, *, blank, max_len, S,
          taken=None):
    B, V = logp.shape
    K = p_b.shape[1]
    cand, tot, cap, _ = _grid(logp, p_b, p_nb, last, phash, plen,
                              blank=blank, max_len=max_len)
    out = []
    for b in range(B):
        special = {blank} | {max(int(c), 0) for c in last[b]}
        # the kernel's shortcut for the other tokens
        for c in range(V):
            if c in special:
                continue
            want = torch.where(cap[b], torch.tensor(NEG),
                               tot[b] + logp[b, c])
            assert torch.equal(cand[b, :, c], want)
        values = [[(float(cand[b, k, c]), k * V + c) for k in range(K)]
                  for c in range(V)]
        merged = sorted((e for lst in _slice_lists(values, S, K, True, taken)
                         for e in lst), key=_key)
        out.append(_stamp(merged, K))
    return torch.tensor(out, dtype=torch.int32)


def _state(B, K, V, U, frames, seed, ties=()):
    g = torch.Generator().manual_seed(seed)
    st = DB.init_state(B, K, U, "cpu")
    for _ in range(frames):
        lp = torch.log_softmax(torch.randn(B, V, generator=g) * 3.0, -1)
        sel, npb, npnb = DB.frame_step_scores(
            lp, st.p_b, st.p_nb, st.last, st.phash, st.lens, blank=0,
            max_len=U, semiring="max")
        st = DB.apply_selection(st, sel, npb, npnb, blank=0, vocab=V)
    lp = torch.log_softmax(torch.randn(B, V, generator=g) * 3.0, -1)
    for a, b in ties:            # equal log-probs: ties broken by index
        lp[:, b] = lp[:, a]
    return st, lp


@pytest.mark.parametrize("B,K,V,U,frames,blank,S,ties", [
    (2, 4, 40, 6, 4, 0, 8, ((4, 5), (9, 10))),     # ties across bounds
    (2, 8, 600, 8, 5, 3, 3, ((199, 200), (1, 599))),
    (1, 16, 700, 8, 3, 0, 8, ((86, 87),)),        # K = 16
    (3, 5, 1001, 4, 3, 0, 7, ()),                 # V not a multiple of S
    (2, 4, 9, 6, 4, 0, 1, ()),                    # prefixes merge
    (2, 3, 17, 2, 5, 3, 4, ()),                   # U cap reached
])
def test_twin_selects_like_frame_step(B, K, V, U, frames, blank, S, ties):
    st, lp = _state(B, K, V, U, frames, seed=K * V, ties=ties)
    for max_len in (U, 0):       # 0: fewer live candidates than K
        args = (lp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
        want = DB.frame_step_scores(*args, blank=blank, max_len=max_len,
                                    semiring="max")[0]
        got = _twin(*args, blank=blank, max_len=max_len, S=S)
        assert torch.equal(got, want), (got, want)


def test_twin_sees_kills_in_another_slice():
    """Merged prefixes kill extends (k, last[j]); with 8 slices of 5
    tokens those kills sit in other slices than most of the parent's
    candidates, and the selection still matches."""
    st, lp = _state(2, 6, 40, 8, 3, seed=2)
    args = (lp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
    _, _, _, match = _grid(*args, blank=0, max_len=8)
    assert bool(match.any())
    bounds = DK.beam_bounds(40, 8)
    kill_slices = {s for b, _, j in match.nonzero().tolist()
                   for s, (lo, hi) in enumerate(bounds)
                   if lo <= int(st.last[b, j]) < hi}
    assert 1 <= len(kill_slices) < len(bounds)
    want = DB.frame_step_scores(*args, blank=0, max_len=8,
                                semiring="max")[0]
    assert torch.equal(_twin(*args, blank=0, max_len=8, S=8), want)


@pytest.mark.parametrize("V,C,S", [(40, 5, 8), (1001, 16, 7), (600, 16, 3)])
def test_twin_topc_tokens_like_topc_scores(V, C, S):
    """The pruned body's top-C tokens: each warp's best C of its tokens,
    CTA 0's merge and the stamp rule give ``topc_scores``' indices, with
    ties across slice bounds and a row of NEG and -inf entries."""
    g = torch.Generator().manual_seed(V)
    lp = torch.log_softmax(torch.randn(2, V, generator=g) * 3.0, -1)
    lo, hi = DK.beam_bounds(V, S)[1]
    lp[:, hi] = lp[:, hi - 1]
    lp[1, :] = -torch.inf                 # fewer than C live tokens
    lp[1, 3] = NEG
    lp[1, 7] = 0.0
    lp[1, 2] = NEG
    want = DB.topc_scores(lp, C)[1]
    for b in range(2):
        values = [[(float(lp[b, c]), c)] for c in range(V)]
        merged = sorted((e for lst in _slice_lists(values, S, C, C <= 16)
                         for e in lst), key=_key)
        assert _stamp(merged, C) == want[b].tolist()


def test_twin_takes_both_ways():
    """At the plan's slices (at least 512 tokens, so every warp holds
    some) a mid-utterance state ranks a few dozen candidates a slice; with
    every parent capped (max_len 0) the slices' candidates tie at NEG, tau
    is NEG and more than CAP reach it, so the warps' lists are merged."""
    st, lp = _state(2, 8, 1600, 8, 5, seed=4800)
    args = (lp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
    for max_len, ranked in ((8, True), (0, False)):
        taken = []
        got = _twin(*args, blank=3, max_len=max_len, S=3, taken=taken)
        want = DB.frame_step_scores(*args, blank=3, max_len=max_len,
                                    semiring="max")[0]
        assert torch.equal(got, want)
        assert set(taken) == {ranked}
