"""The work list of the fused dense-MoE kernel (K10): ``moe_dense.work_list``,
the plain version of the list the kernel's first launch builds on the
card, held against a construction in numpy loops; and a float64
emulation of the kernel's data flow (each used pair's weighted FFN row
written to its slot, each token's slots summed in ascending expert
order) held against the dense float64 sum of ``moe_dense_plain``'s terms.

Cases at granite's 40 experts, top-8: T = 1, 8, 700 and 1500; every
weight non-zero; one expert never selected; a token whose whole row is
zero; top-8 drawn only from experts 32-39.  The device's list is held
against this one on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_dense as MD  # noqa: E402

E, K = 40, 8
NEVER = 17


def _router(T, mode, seed, E=E, k=K):
    """(T, E) f32 combine weights: the renormalised top-k of a softmax;
    "all": the whole softmax; "skip": expert NEVER never selected;
    "zero_row": token T // 2 with no weight; "last8": top-k of experts
    32-39 only."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E))
    if mode == "skip":
        logits[:, NEVER] = -np.inf
    if mode == "last8":
        logits[:, :32] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    if mode != "all":
        idx = np.argsort(-p, -1)[:, :k]
        top = np.take_along_axis(p, idx, -1)
        p = np.zeros_like(p)
        np.put_along_axis(p, idx, top / top.sum(-1, keepdims=True), -1)
    if mode == "zero_row":
        p[T // 2] = 0.0
    return p.astype(np.float32)


def _numpy_list(w, rows):
    """The work list by loops: pairs expert by expert, tokens ascending;
    a pair's slot is its token's first slot plus the experts before it."""
    T, E = w.shape
    nz = w != 0
    tok_nnz = nz.sum(1)
    tok_off = np.concatenate([[0], np.cumsum(tok_nnz)[:-1]])
    pair_tok, pair_slot, counts, items = [], [], [], []
    for e in range(E):
        first = len(pair_tok)
        for t in range(T):
            if nz[t, e]:
                pair_tok.append(t)
                pair_slot.append(tok_off[t] + int(nz[t, :e].sum()))
        counts.append(len(pair_tok) - first)
        for j in range(0, counts[-1], rows):
            items.append((e, first + j, min(rows, counts[-1] - j)))
    return (np.array(counts), np.array(pair_tok, np.int64),
            np.array(pair_slot, np.int64), tok_nnz, tok_off,
            np.array(items, np.int64).reshape(-1, 3))


CASES = [(1, "topk"), (8, "topk"), (700, "topk"), (1500, "topk"),
         (64, "all"), (300, "skip"), (37, "zero_row"), (1, "last8"),
         (8, "last8")]


@pytest.mark.parametrize("T,mode", CASES)
def test_work_list_matches_numpy(T, mode):
    w = _router(T, mode, seed=T)
    got = MD.work_list(torch.from_numpy(w))
    want = _numpy_list(w, MD.item_rows(T))
    for name, g, n in zip(got._fields, got, want):
        assert np.array_equal(g.numpy(), n), name
    # every pair once, and the slots a permutation of 0 .. P - 1
    P = int((w != 0).sum())
    assert len(got.pair_tok) == P
    assert sorted(got.pair_slot.tolist()) == list(range(P))
    assert int(got.items[:, 2].sum()) == P
    assert bool((got.items[:, 2] >= 1).all())
    assert bool((got.items[:, 2] <= MD.item_rows(T)).all())


@pytest.mark.parametrize("T,mode", CASES)
def test_work_list_cases(T, mode):
    """What each case is there for."""
    w = _router(T, mode, seed=T)
    wl = MD.work_list(torch.from_numpy(w))
    rows = MD.item_rows(T)
    used = (wl.counts > 0).nonzero().flatten().tolist()
    if mode == "skip":
        assert NEVER not in used and int(wl.counts[NEVER]) == 0
        assert NEVER not in wl.items[:, 0].tolist()
    if mode == "zero_row":
        assert int(wl.tok_nnz[T // 2]) == 0
        assert T // 2 not in wl.pair_tok.tolist()
    if mode == "last8":
        assert used == list(range(32, 40))
        assert wl.items[:, 0].tolist() == list(range(32, 40))
    if mode == "all":
        assert bool((wl.tok_nnz == E).all())
    if T <= MD.DECODE_T:
        # at decode an item is all of one expert's tokens
        assert rows == 16 and len(wl.items) == len(used)
    else:
        assert rows == MD.ITEM_ROWS


def _ffn64(x, wi, wg, wo, act):
    """Every expert's FFN in float64 with the plain version's hidden
    rounding left out: (T, E, d)."""
    h = np.einsum("td,edf->tef", x, wi)
    if act == "swiglu":
        g = np.einsum("td,edf->tef", x, wg)
        a = g / (1 + np.exp(-g)) * h
    else:
        a = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) *
                                   (h + 0.044715 * h ** 3)))
    return np.einsum("tef,efd->ted", a, wo)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("T,mode", [(1, "topk"), (8, "last8"),
                                    (37, "zero_row"), (150, "skip"),
                                    (64, "all")])
def test_emulated_data_flow_matches_the_dense_sum(T, mode, act):
    """Gather each pair's token, its weighted FFN row into its slot, each
    token's slots summed in ascending expert order: the dense float64 sum
    over every expert, to float64 rounding; a token with no weight is an
    exact 0 row."""
    d, f = 32, 16
    rng = np.random.default_rng(T + 7)
    x = rng.standard_normal((T, d))
    wi = rng.standard_normal((E, d, f)) / np.sqrt(d)
    wg = rng.standard_normal((E, d, f)) / np.sqrt(d)
    wo = rng.standard_normal((E, f, d)) / np.sqrt(f)
    w = _router(T, mode, seed=T).astype(np.float64)
    ye = _ffn64(x, wi, wg, wo, act)
    dense = np.einsum("ted,te->td", ye, w)

    wl = MD.work_list(torch.from_numpy(w))
    slots = np.full((int(wl.tok_nnz.sum()), d), np.nan)
    for e, p0, n in wl.items.tolist():
        for p in range(p0, p0 + n):
            t = int(wl.pair_tok[p])
            slots[int(wl.pair_slot[p])] = w[t, e] * ye[t, e]
    assert not np.isnan(slots).any()            # every slot written once
    y = np.zeros((T, d))
    for t in range(T):
        off, n = int(wl.tok_off[t]), int(wl.tok_nnz[t])
        experts = [e for e in range(E) if w[t, e] != 0]
        for j, e in enumerate(experts):         # slot j is the j-th expert
            assert np.array_equal(slots[off + j], w[t, e] * ye[t, e])
        for j in range(n):
            y[t] += slots[off + j]
    scale = np.abs(dense).max(-1, keepdims=True) + 1e-300
    assert np.abs(y - dense).max() <= 1e-12 * scale.max()
    assert np.all(np.abs(y - dense) <= 1e-12 * scale)
    if mode == "zero_row":
        assert np.array_equal(y[T // 2], np.zeros(d))
