"""The launch plan of the decode-attention kernels K7 and K8
(``repro_torch.kernels.decode_attention.decode_plan``), on the CPU.

Each (batch row, KV head)'s admitted cache rows ``[lo, hi)`` are cut into
``n_split`` splits of whole ``block_s``-row tiles, one CTA each; the
kernel merges the splits' partial softmax sums in rank order.  These
tests hold the plan to its contract: the splits cover exactly the rows
the reference admits, in order, on tile (page) edges, none empty; the
walk starts at the window; the grid reaches the SM count where the rows
allow; K7 at ``block_s = P`` and K8 with pages of P get one plan (so the
kernels' bits can agree).  The split-and-merge arithmetic itself is
emulated in float64 against the plain version.  No GPU is needed: the
bound the card sets (``fit_splits``: the most splits whose clusters run
at once) is passed in, here from a model of the H100 at two CTAs an SM.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as DA  # noqa: E402

N_SM = 132


def _fit(groups):
    """The most splits whose ``groups`` clusters fit 2·N_SM CTA slots
    (the model of ``fit_splits`` here)."""
    n = 1
    while n < DA.MAX_SPLIT and 2 * N_SM // (n + 1) >= groups:
        n += 1
    return n

# (B, KV, S, E): smollm-360m (5 KV heads), hymba-1.5b's cache of 2048
# (5 KV heads of M = 5), granite-moe-3b-a800m (8 KV heads), at the
# servers' 8 slots and at one request; M = 16 at E = 256 over one KV
# head; a small odd shape
SHAPES = [(8, 5, 1024, 64), (1, 5, 1024, 64), (8, 5, 2048, 64),
          (1, 5, 2048, 64), (8, 8, 1024, 64), (1, 8, 1024, 64),
          (1, 1, 4096, 256), (3, 2, 40, 32)]


def _cases(S):
    for pos in sorted({0, 1, 15, 16, 17, S // 3, S // 2 + 5, S - 1}):
        for window in (None, 1, 7, 100, 1024):
            for delta in (False, True):
                for block_s in (1, 8, 16, 128):
                    yield pos, window, delta, block_s


def split_bounds(plan, block_s):
    """The row ranges ``[t0, t1)`` of the plan's splits, in rank order, as
    ``decode_attention.cu`` cuts them: split k takes tiles
    ``[tiles·k // n_split, tiles·(k + 1) // n_split)`` of the range,
    clipped to ``[lo, hi)``."""
    if plan.tiles == 0:
        return [(plan.lo, plan.lo)]
    s0 = plan.lo // block_s
    cut = [s0 + plan.tiles * k // plan.n_split
           for k in range(plan.n_split + 1)]
    return [(max(plan.lo, a * block_s), min(plan.hi, b * block_s))
            for a, b in zip(cut[:-1], cut[1:])]


def _admitted(S, pos, window, delta):
    win = DA.NO_WINDOW if window is None else window
    return max(0, pos - win + 1), min(S, pos if delta else pos + 1)


def _plans(B, KV, S, E):
    for pos, window, delta, block_s in _cases(S):
        lo, hi = _admitted(S, pos, window, delta)
        if hi <= lo and not delta:
            continue
        plan = DA.decode_plan(B, KV, S, E, pos, window, delta, block_s,
                              _fit(B * KV))
        yield (pos, window, delta, block_s), lo, hi, plan


@pytest.mark.parametrize("B,KV,S,E", SHAPES)
def test_splits_cover_the_admitted_rows_in_order(B, KV, S, E):
    """Contiguous, in order, exactly [lo, hi), interior edges on tile
    edges, none empty, none longer than the plan's ``rows``."""
    for case, lo, hi, plan in _plans(B, KV, S, E):
        block_s = case[3]
        bounds = split_bounds(plan, block_s)
        assert len(bounds) == plan.n_split, case
        assert bounds[0][0] == lo and bounds[-1][1] == max(lo, hi), case
        for (a0, a1), (b0, _) in zip(bounds[:-1], bounds[1:]):
            assert a1 == b0 and a1 % block_s == 0, case
        if hi > lo:
            assert all(t1 > t0 for t0, t1 in bounds), case
            assert all(t1 - t0 <= plan.rows for t0, t1 in bounds), case
        else:
            assert bounds == [(lo, lo)] and plan.n_split == 1, case


@pytest.mark.parametrize("B,KV,S,E", SHAPES)
def test_walk_starts_at_the_window(B, KV, S, E):
    """lo = max(0, pos - window + 1); hi = pos + 1 (canonical) or pos
    (delta), at most S; the tiles counted from lo's tile, not from 0."""
    for (pos, window, delta, block_s), lo, hi, plan in _plans(B, KV, S, E):
        assert (plan.lo, plan.hi) == (lo, max(lo, hi))
        want = -(-hi // block_s) - lo // block_s if hi > lo else 0
        assert plan.tiles == want


def test_hymba_window_skips_the_rows_before_it():
    """hymba-1.5b's decode at pos 1600 under its 1024-row window reads
    the 1023 old rows 577..1599: 64 tiles of 16 where a walk from
    position 0 takes 100."""
    plan = DA.decode_plan(8, 5, 2048, 64, 1600, 1024, True, 16, _fit(40))
    assert (plan.lo, plan.hi, plan.tiles) == (577, 1600, 64)
    rows = sum(t1 - t0 for t0, t1 in split_bounds(plan, 16))
    assert rows == 1023


@pytest.mark.parametrize("B,KV,S,E", SHAPES)
def test_split_count_fills_the_card_where_the_rows_allow(B, KV, S, E):
    """1 <= n_split <= 16 and at most the card's bound (one wave).  The
    longest split is as short as the caps allow — that bound, 16 splits,
    one per tile, one per MIN_SPLIT_ROWS rows — and n_split the fewest
    splits that short."""
    fit = _fit(B * KV)
    for case, lo, hi, plan in _plans(B, KV, S, E):
        assert 1 <= plan.n_split <= min(fit, DA.MAX_SPLIT), case
        if hi <= lo:
            continue
        cap = max(1, min(fit, DA.MAX_SPLIT, plan.tiles,
                         (hi - lo) // DA.MIN_SPLIT_ROWS))
        per = -(-plan.tiles // cap)
        assert plan.rows == per * case[3], case
        assert -(-plan.tiles // plan.n_split) == per, case
        assert -(-plan.tiles // (plan.n_split - 1 or 1)) > per or \
            plan.n_split == 1, case


@pytest.mark.parametrize("B,KV,pos,window,n_fit,n_split", [
    (8, 5, 511, None, 6, 6),        # smollm, 8 slots: 240 CTAs of 96 rows
    (8, 5, 511, None, 4, 4),        # ... where the card runs 4 a cluster
    (1, 5, 511, None, 16, 11),      # one request: 511 rows // 32 = 15
                                    # splits of at most 3 tiles, or 11
    (8, 5, 1600, 1024, 4, 4),       # hymba's window: 256 rows a split
    (1, 5, 1600, 1024, 16, 16),     # one request, capped at 16
    (8, 8, 511, None, 4, 4),        # granite: 256 CTAs of 128 rows
])
def test_serving_shapes(B, KV, pos, window, n_fit, n_split):
    plan = DA.decode_plan(B, KV, 2048, 64, pos, window, True, 16, n_fit)
    assert plan.n_split == n_split
    assert plan.rows == -(-plan.tiles // n_split) * 16


@pytest.mark.parametrize("delta", [False, True])
def test_dense_and_paged_calls_get_one_plan(delta):
    """K7 is planned over its cache's S rows, K8 over W·P; both at
    block_s = P.  The plan depends on S only through min(hi, S), so a
    dense cache and a pool table that both hold pos plan alike."""
    P = 16
    for B, KV, S, E in SHAPES:
        for pos, window, _, _ in _cases(S):
            for W in (-(-(pos + 1) // P), S // P + 3):
                dense = DA.decode_plan(B, KV, S, E, pos, window, delta, P,
                                       _fit(B * KV))
                paged = DA.decode_plan(B, KV, W * P, E, pos, window, delta,
                                       P, _fit(B * KV))
                assert dense == paged, (B, KV, S, pos, window, W)


def test_empty_ranges_and_refusals():
    # the delta variant with no old row: one split of none
    for pos, window in ((0, None), (9, 1)):
        plan = DA.decode_plan(2, 3, 64, 64, pos, window, True, 16, 16)
        assert (plan.n_split, plan.tiles, plan.rows) == (1, 0, 0)
        assert plan.lo == plan.hi
    # the canonical variant always admits pos itself...
    plan = DA.decode_plan(2, 3, 64, 64, 9, 1, False, 16, 16)
    assert (plan.lo, plan.hi, plan.n_split) == (9, 10, 1)
    # ...unless the window lies wholly past the cache
    with pytest.raises(ValueError, match="no cache row"):
        DA.decode_plan(2, 3, 64, 64, 80, 4, False, 16, 16)
    for pos, window in ((-1, None), (5, 0)):
        with pytest.raises(ValueError, match="must be"):
            DA.decode_plan(2, 3, 64, 64, pos, window, False, 16, 16)


def test_longest_split_rows():
    """The plan's longest split, in rows (the kernel sizes its copy
    rounds from it: 16 KB of K rows at most): whole tiles, as few splits
    as keep it that short."""
    plan = DA.decode_plan(1, 1, 4096, 256, 4095, None, False, 16, 16)
    assert (plan.tiles, plan.n_split, plan.rows) == (256, 16, 256)
    plan = DA.decode_plan(1, 1, 4096, 128, 4095, None, False, 16, 4)
    assert (plan.n_split, plan.rows) == (4, 1024)
    plan = DA.decode_plan(1, 1, 8192, 64, 8191, None, False, 128, 16)
    assert (plan.tiles, plan.n_split, plan.rows) == (64, 16, 512)
    plan = DA.decode_plan(1, 5, 1024, 64, 511, None, True, 16, 16)
    assert (plan.n_split, plan.rows) == (11, 48)


def _emulate(q, k, v, pos, window, kn, vn, block_s):
    """The kernel's split-and-merge in float64: each split's (m, l, acc)
    over its rows, then the splits in rank order, the delta variant's new
    column first (p = 1 at its own max)."""
    B, _, H, E = q.shape
    S, KV = k.shape[1], k.shape[2]
    M = H // KV
    plan = DA.decode_plan(B, KV, S, E, pos, window, kn is not None,
                          block_s, _fit(B * KV))
    qg = q.reshape(B, KV, M, E).double()
    scale = DA._scale(E)
    parts = []
    if kn is not None:
        s_new = torch.einsum("bgme,bge->bgm", qg, kn[:, 0].double()) * scale
        acc = vn[:, 0].double()[:, :, None, :].expand(B, KV, M, E)
        parts.append((s_new, torch.ones_like(s_new), acc))
    for t0, t1 in split_bounds(plan, block_s):
        if t1 == t0:
            continue
        s = torch.einsum("bgme,btge->bgmt", qg, k[:, t0:t1].double()) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bgmt,btge->bgme", p,
                                   v[:, t0:t1].double())))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    return (acc / lsum[..., None]).reshape(B, 1, H, E), plan


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("B,KV,M,S,E,block_s", [
    (1, 2, 3, 700, 32, 16),      # many splits of one row
    (4, 2, 5, 300, 16, 8),
    (2, 1, 16, 520, 64, 1),
])
def test_split_merge_emulation_matches_plain(delta, B, KV, M, S, E,
                                             block_s):
    rng = np.random.default_rng(S + M)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    q, k, v = r(B, 1, KV * M, E), r(B, S, KV, E), r(B, S, KV, E)
    kn, vn = (r(B, 1, KV, E), r(B, 1, KV, E)) if delta else (None, None)
    seen = set()
    for pos in (0, 1, block_s, S // 2, S - 1):
        for window in (None, 1, 37, S // 3):
            got, plan = _emulate(q, k, v, pos, window, kn, vn, block_s)
            seen.add(plan.n_split)
            want = DA.decode_attention_ref(q, k, v, pos, window=window,
                                           k_new=kn, v_new=vn)
            err = float((got.float() - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()) + 1e-6, \
                (pos, window, err)
    assert max(seen) > 1
