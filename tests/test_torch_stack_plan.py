"""The launch rules of the fused stack K4 (``lstm_cell.stack_plan``) and
of the argmax kernel K6 (``decode.kernel.argmax_slices`` and
``argmax_bounds``), on the CPU.

K4 runs each layer's recurrences on clusters of 16 CTAs that hold Wh in
shared memory wherever H splits into 16 slices of whole float4s, at the
fewest tile rows whose clusters fit one wave of what the card holds at
once; where H does not split it runs one 512-thread block an item.  K6
splits each row over a cluster of up to 8 CTAs, cut in whole 16-byte
vectors from the row's first 16-byte boundary, and merges the slices'
(value, index) pairs under one total order; a plain-Python merge of
per-slice pairs is held against ``argmax_ref`` here, whatever the slicing
and the merge order.
"""
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.decode import kernel as DK  # noqa: E402
from repro_torch.kernels import lstm_cell as LC  # noqa: E402

H = 512                     # the paper's cells per direction
ACTIVE = 7                  # resident clusters of 16 the H100 holds at once


@pytest.mark.parametrize("B,want", [
    (1, LC.StackPlan("resident", 1, 2, 1)),      # an ASR serve admission
    (8, LC.StackPlan("resident", 4, 4, 1)),      # evaluate's batch of 8
    (3, LC.StackPlan("resident", 1, 6, 1)),
    (16, LC.StackPlan("resident", 4, 8, 2)),     # chip_smoke's B = 16, T = 21
])
def test_plan_at_the_main_path_shapes(B, want):
    """1-row tiles at B = 1 (2 clusters), 4-row tiles at B = 8 (4
    clusters, one wave: 2-row tiles would make 8 clusters, two waves of
    7); B = 16 needs more clusters than one wave holds even at 4 rows."""
    assert LC.stack_plan(B, H, ACTIVE) == want


@pytest.mark.parametrize("active", [7, 6, 4, 3, 2, 1])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("L", [1, 2])
def test_one_wave_where_promised(B, active, L):
    """The clusters are the items, 2·L·ceil(B / rows); the waves are
    what the card's ``active`` clusters need; one wave whenever some tile
    of at most 4 rows gives one, at the fewest such rows."""
    plan = LC.stack_plan(B, H, active, L)
    assert plan.path == "resident" and plan.block_rows in (1, 2, 4)
    assert plan.clusters == 2 * L * math.ceil(B / plan.block_rows)
    assert plan.waves == math.ceil(plan.clusters / active)
    fits = [r for r in (1, 2, 4) if 2 * L * math.ceil(B / r) <= active]
    if fits:
        assert plan.waves == 1 and plan.block_rows == fits[0]
    else:       # waves of the widest useful tile, never wider than B
        assert plan.block_rows == min(4, LC.block_rows(B))


@pytest.mark.parametrize("width", range(16, 513, 16))
def test_item_path_exactly_where_h_does_not_split(width):
    """A multiple of 64 splits into 16 slices of whole float4s and fits
    (at most 189,504 bytes of shared memory at 4-row tiles, H = 512);
    every other width runs the 512-thread items, at block_rows(B) rows."""
    splits = width % 64 == 0
    assert LC.stack_resident(width) == splits
    plan = LC.stack_plan(5, width, ACTIVE)
    if splits:
        assert plan.path == "resident"
    else:
        assert plan == LC.StackPlan("item", 8, 0, 0)


def test_k4_cases_of_chip_smoke():
    """chip_smoke.py's K4 cases: B = 5 at H = 16 on the item path (8-row
    tiles, ragged); B = 1, 8 and 16 resident."""
    assert LC.stack_plan(5, 16, ACTIVE) == LC.StackPlan("item", 8, 0, 0)
    assert [LC.stack_plan(B, H, ACTIVE).block_rows for B in (1, 8, 16)] \
        == [1, 4, 4]


def test_shared_memory_of_a_resident_stack_cta():
    """The resident forward's regions and two x-projection tiles of
    20,992 bytes: 189,504 bytes at 4-row tiles, within 232,448."""
    assert LC.stack_smem(H, 4) == 131072 + 16384 + 64 + 2 * 20992
    assert LC.stack_smem(H, 1) < LC.stack_smem(H, 4) <= LC.SMEM_LIMIT


@pytest.mark.parametrize("active", [0, -2])
def test_a_resident_stack_that_cannot_be_scheduled_raises(active):
    with pytest.raises(ValueError, match="cannot be scheduled"):
        LC.stack_plan(8, H, active)
    assert LC.stack_plan(8, 16, active).path == "item"   # no query needed


# ---------------------------------------------------------------- K6

@pytest.mark.parametrize("B,V,itemsize,n_sm,want", [
    (1, 7, 2, 132, 1),            # fewer vectors than one CTA's threads
    (1, 1, 4, 132, 1),
    (8, 49152, 2, 132, 8),        # smollm-360m's decode group
    (8, 49153, 2, 132, 8),
    (4, 151936, 2, 132, 8),
    (1, 49152, 4, 132, 8),
    (20, 49152, 2, 132, 6),       # B·S ≤ the SM count
    (132, 49152, 2, 132, 1),
    (500, 49152, 2, 132, 1),
    (1, 4096, 2, 132, 2),         # 512 vectors: two CTAs of 256 threads
])
def test_argmax_slices(B, V, itemsize, n_sm, want):
    S = DK.argmax_slices(B, V, itemsize, n_sm)
    assert S == want and 1 <= S <= DK.MAX_SLICES
    assert S == 1 or B * S <= n_sm


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("V", [1, 7, 49152, 49153, 151936])
def test_argmax_bounds_cover_the_row_once(V, itemsize):
    """For every slice count and every offset of the row from a 16-byte
    boundary: the slices tile [0, V) in order, and each internal bound
    lies on a whole vector from the row's first boundary."""
    per = 16 // itemsize
    for S in range(1, DK.MAX_SLICES + 1):
        for head in range(per):
            b = DK.argmax_bounds(V, S, itemsize, head)
            assert len(b) == S and b[0][0] == 0 and b[-1][1] == V
            assert all(lo <= hi for lo, hi in b)
            assert all(b[i][1] == b[i + 1][0] for i in range(S - 1))
            h = min(head, V)
            assert all((hi - h) % per == 0 for _, hi in b[:-1])
            n_vec = (V - h) // per
            sizes = [hi - lo for lo, hi in b[1:-1]]
            assert all(abs(x - per * n_vec / S) <= per for x in sizes)


def _better(av, ai, bv, bi):
    """argmax.cu's order: NaN first, then the larger value, then the
    smaller index."""
    an, bn = math.isnan(av), math.isnan(bv)
    if an or bn:
        return an and (not bn or ai < bi)
    return av > bv or (av == bv and ai < bi)


def _merge(pairs):
    best = (-math.inf, 2 ** 31 - 1)
    for v, i in pairs:
        if _better(v, i, *best):
            best = (v, i)
    return best


def _sliced_argmax(row, S, head, order):
    """The kernel's reduction in plain Python: each slice's best pair,
    its elements taken in a shuffled order (threads and warps merge in
    no fixed order), then the slices' pairs merged in ``order``."""
    rng = random.Random(S * 31 + head)
    pairs = []
    for lo, hi in DK.argmax_bounds(len(row), S, 2, head):
        idx = list(range(lo, hi))
        rng.shuffle(idx)
        pairs.append(_merge((float(row[i]), i) for i in idx))
    return _merge(pairs[s] for s in order(S))[1]


def _hard_rows(V, S, head):
    """Rows that a wrong merge would get wrong: equal maxima on both
    sides of every slice bound, NaN only in the last slice (an inf
    earlier), an all -inf row, and many ties."""
    g = np.random.default_rng(V + S)
    bounds = DK.argmax_bounds(V, S, 2, head)
    rows = []
    r = g.standard_normal(V).astype(np.float32)
    for lo, hi in bounds:
        if lo < hi:
            r[lo] = r[hi - 1] = 7.0
    rows.append(r)
    r = g.standard_normal(V).astype(np.float32)
    r[0] = np.inf
    lo, hi = bounds[-1]
    r[lo:hi][::3] = np.nan
    rows.append(r)
    rows.append(np.full(V, -np.inf, np.float32))
    rows.append(np.round(g.standard_normal(V) * 2).astype(np.float32) / 2)
    return rows


@pytest.mark.parametrize("V", [1, 7, 4099, 49153])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_sliced_merge_equals_the_plain_argmax(V, S):
    orders = (lambda n: range(n), lambda n: reversed(range(n)),
              lambda n: random.Random(n).sample(range(n), n))
    for head in (0, 3):
        for row in _hard_rows(V, S, head):
            want = int(DK.argmax_ref(torch.from_numpy(row)[None])[0])
            for order in orders:
                assert _sliced_argmax(row, S, head, order) == want
