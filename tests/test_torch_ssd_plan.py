"""The launch plan of the chunk-parallel SSD scan (K9 port,
``kernels.ssd_scan.ssd_plan``) and the arithmetic of its two launches,
emulated on the CPU:

* ``ssd_plan`` at the served and edge shapes: the chunks and the ragged
  last one, the (row, chunk, head) items, the channels of P an output
  CTA owns and the scratch;
* ``_twin``, a plain torch twin of the kernel's decomposition: each
  chunk's state contribution S_c and total T_c (launch 1), then each
  chunk's entering state by the recurrence h = exp(T_j) h + S_j over the
  earlier chunks, y from the chunk's scores and that state, and the final
  state (launch 2), every decay exponent built the kernel's way (16-step
  segments: a table of direct sums within one, prefix + whole segments +
  suffix across).  It is held against ``ref.ssd_plain`` in f32 (1e-5
  normalised: the same f32 sums in another order), against JAX's Pallas
  ``ssd`` in interpret mode where S % Q == 0 (bf16 inputs: y within one
  bf16 rounding, the state 1e-5), and in float64 against the exact
  recurrence in float64 (1e-10); at mamba2-like strong decay its f32
  state stays within 1e-4 of the sequential recurrence;
* the bf16 kernel's split of each f32 operand of a product (W, wk . x,
  h) into bf16 parts, emulated in float64: one part (a single bf16
  rounding) puts the state past the checks' 1e-4, two and three parts
  hold it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd as jax_ssd  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as TS  # noqa: E402

H100_SMS = 132
BF16_ULP = 2.0 ** -8
SEG = 16


def _inputs(B, S, H, P, N, seed, G=None, bf16=False, strong=False):
    rng = np.random.default_rng(seed)
    G = G or H
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    if strong:                 # mamba2-370m's init: dt*A reaches ~-85 a step
        dt = dt * 40.0
    if bf16:
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(
            np.float32) for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a)).to(dtype) for a in arrays]


def _err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("B,S,H,P,G,N,Q,chunks,last,p_tile", [
    (1, 700, 32, 64, 1, 128, 256, 3, 188, 64),    # mamba2-370m, ragged
    (1, 1500, 50, 64, 1, 16, 256, 6, 220, 64),    # hymba-1.5b
    (1, 1, 32, 64, 1, 128, 256, 1, 1, 32),        # S = 1: 32 items, split P
    (1, 40, 3, 16, 3, 8, 16, 3, 8, 32),           # S < 64, Q < 64, ragged
    (2, 100, 4, 32, 2, 64, 32, 4, 4, 32),         # G < H, P = 32
    (1, 2048, 32, 64, 1, 128, 256, 8, 256, 64),   # 8 whole chunks
    (1, 2500, 32, 64, 1, 128, 256, 10, 196, 64),  # more than 8 chunks
    (3, 100, 4, 24, 2, 12, 32, 4, 4, 32),         # P not a multiple of 8
    (4, 512, 32, 64, 1, 128, 256, 2, 256, 64),    # rows fill the card
])
def test_ssd_plan_items_slices_and_memory(B, S, H, P, G, N, Q, chunks,
                                          last, p_tile):
    plan = TS.ssd_plan(B, S, H, P, G, N, Q, H100_SMS)
    assert plan["chunks"] == chunks
    assert S - (chunks - 1) * min(Q, S) == last
    assert plan["items"] == B * chunks * H
    assert plan["p_tile"] == p_tile
    # 32-channel slices where P needs no more or where the items fill at
    # most half the card, else 64
    assert (p_tile == 32) == (P <= 32 or 2 * plan["items"] <= H100_SMS)
    assert plan["scratch_bytes"] == 4 * plan["items"] * (P * N + 1)


def test_ssd_plan_served_shapes():
    """Both served prefills: one output CTA per (row, chunk, head), 96 at
    mamba2's S = 700 and 300 at hymba's S = 1500, where the serial kernel
    walked 128 (mamba2) and 200 (hymba) CTAs of 16 channels over every
    chunk in order, each CTA computing every score."""
    m = TS.ssd_plan(1, 700, 32, 64, 1, 128, 256, H100_SMS)
    h = TS.ssd_plan(1, 1500, 50, 64, 1, 16, 256, H100_SMS)
    assert (m["items"], m["p_tile"]) == (96, 64)
    assert (h["items"], h["p_tile"]) == (300, 64)
    assert m["scratch_bytes"] == 4 * 96 * (64 * 128 + 1)      # ~3.1 MB


# ------------------------------------------------------------- the twin

def _segments(dA):
    """The kernel's decay tables for one chunk's dA (L,): cl (dA from q's
    segment start through q), rem (dA after k in k's segment), the
    whole-segment sums between two segments, before / after each segment,
    the within-segment table of direct sums, and the (L, L) exponent
    matrix built from them (k <= q; -inf above)."""
    L = dA.shape[0]
    Lp = -(-L // SEG) * SEG
    a = torch.zeros(Lp, dtype=dA.dtype)
    a[:L] = dA
    seg = a.view(-1, SEG)
    cl = torch.cumsum(seg, 1).reshape(-1)
    rem = (torch.flip(torch.cumsum(torch.flip(seg, [1]), 1), [1])
           - seg).reshape(-1)
    tot = seg.sum(1)
    ns = tot.shape[0]
    between = torch.zeros(ns, ns, dtype=dA.dtype)
    before = torch.zeros(ns, dtype=dA.dtype)
    after = torch.zeros(ns, dtype=dA.dtype)
    for s1 in range(ns):
        before[s1] = tot[:s1].sum()
        after[s1] = tot[s1 + 1:].sum()
        for s2 in range(s1 + 2, ns):
            between[s1, s2] = tot[s1 + 1:s2].sum()
    expo = torch.full((L, L), -torch.inf, dtype=dA.dtype)
    for q in range(L):
        for k in range(q + 1):
            sq, sk = q // SEG, k // SEG
            if sq == sk:
                expo[q, k] = a[k + 1:q + 1].sum() if q > k else 0.0
            else:
                expo[q, k] = cl[q] + between[sk, sq] + rem[k]
    cum = before[torch.arange(L) // SEG] + cl[:L]            # dA over 0..q
    after_k = rem[:L] + after[torch.arange(L) // SEG]        # dA after k
    return expo, cum, after_k, before[-1] + tot[-1]


def _twin(x, dt, A, Bm, Cm, *, chunk, split=None):
    """The kernel's two launches in plain torch, in x's dtype; ``split``,
    if given, is applied to the f32 operand of each product (W, wk . x,
    h) first."""
    op = split or (lambda v: v)
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    Bh, Ch = TR.expand_groups(Bm, H), TR.expand_groups(Cm, H)
    nc = -(-S // Q)
    y = torch.zeros_like(x)
    h_final = torch.zeros(Bsz, H, Bh.shape[-1], P, dtype=x.dtype)
    for b in range(Bsz):
        for hd in range(H):
            tabs, states, totals = [], [], []
            for c in range(nc):                        # launch 1
                sl = slice(c * Q, min(S, (c + 1) * Q))
                dA = dt[b, sl, hd] * A[hd]
                expo, cum, after_k, total = _segments(dA)
                wk = torch.exp(after_k) * dt[b, sl, hd]
                states.append(Bh[b, sl, hd].T
                              @ op(wk[:, None] * x[b, sl, hd]))
                totals.append(total)
                tabs.append((sl, expo, cum))
            for c, (sl, expo, cum) in enumerate(tabs):  # launch 2
                h = torch.zeros_like(states[0])
                for j in range(c):
                    h = torch.exp(totals[j]) * h + states[j]
                w = (Ch[b, sl, hd] @ Bh[b, sl, hd].T) * torch.exp(expo) \
                    * dt[b, sl, hd][None, :]
                y[b, sl, hd] = op(w) @ x[b, sl, hd] + torch.exp(
                    cum)[:, None] * (Ch[b, sl, hd] @ op(h))
                if c == nc - 1:
                    h_final[b, hd] = torch.exp(totals[c]) * h + states[c]
    return y, h_final


def _recurrence(x, dt, A, Bm, Cm):
    """The exact token-by-token recurrence in x's dtype."""
    Bsz, S, H, P = x.shape
    Bh, Ch = TR.expand_groups(Bm, H), TR.expand_groups(Cm, H)
    h = torch.zeros(Bsz, H, Bh.shape[-1], P, dtype=x.dtype)
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t] * A)[:, :, None, None] * h
             + Bh[:, t, :, :, None] * (dt[:, t, :, None, None]
                                       * x[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 40, 2, 8, 2, 8, 16),       # ragged last chunk
    (2, 7, 2, 8, 1, 8, 16),        # S < Q
    (1, 70, 4, 8, 2, 16, 32),      # G < H, three chunks
    (1, 48, 1, 4, 1, 4, 8),        # Q < 16: one partial segment a chunk
])
def test_twin_matches_ssd_plain_f32(B, S, H, P, G, N, chunk):
    x, dt, A, Bm, Cm = _t(*_inputs(B, S, H, P, N, seed=S + N, G=G))
    ty, th = _twin(x, dt, A, Bm, Cm, chunk=chunk)
    py, ph = TR.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert _err(ty, py) <= 1e-5 and _err(th, ph) <= 1e-5


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32)])
def test_twin_matches_jax_pallas_interpret(S, chunk):
    """S % Q == 0 (the Pallas kernel asserts it), bf16-representable
    inputs: y within one bf16 rounding, the state within 1e-5."""
    x, dt, A, Bm, Cm = _inputs(1, S, 2, 16, 8, seed=S, bf16=True)
    jy, jh = jax_ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                     chunk=chunk, interpret=True)
    ty, th = _twin(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    assert _err(ty, torch.from_numpy(np.array(jy, np.float32))) <= BF16_ULP
    assert _err(th, torch.from_numpy(np.array(jh, np.float32))) <= 1e-5


@pytest.mark.parametrize("S,chunk", [(40, 16), (50, 32)])
def test_twin_float64_equals_exact_recurrence(S, chunk):
    args = _t(*_inputs(1, S, 2, 8, 8, seed=S + 1), dtype=torch.float64)
    ty, th = _twin(*args, chunk=chunk)
    ry, rh = _recurrence(*args)
    assert _err(ty, ry) <= 1e-10 and _err(th, rh) <= 1e-10


def test_twin_state_holds_at_strong_decay():
    """dt*A near mamba2-370m's -85 a step: every exponent a sum of exactly
    its own terms keeps the f32 state within 1e-4 of the f64 recurrence
    (a difference of chunk-level cumsums would not)."""
    x, dt, A, Bm, Cm = _inputs(1, 80, 2, 8, 8, seed=9, strong=True)
    assert float((dt * A[None, None]).min()) < -60
    ty, th = _twin(*_t(x, dt, A, Bm, Cm), chunk=32)
    ry, rh = _recurrence(*_t(x, dt, A, Bm, Cm, dtype=torch.float64))
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    assert _err(th, rh) <= 1e-4 and _err(ty, ry) <= 1e-4


def test_kernel_exponents_equal_segsum():
    """The kernel's exponent table (within-segment direct sums, prefix +
    between + suffix across) is the segment sum of ``ref._segsum``."""
    dA = -torch.from_numpy(np.random.default_rng(3).gamma(
        2.0, 20.0, 70)).to(torch.float64)
    expo, cum, after_k, total = _segments(dA)
    want = TR._segsum(dA[None, :, None])[0, 0]
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(expo))
    assert torch.allclose(expo[finite], want[finite], rtol=1e-12, atol=0)
    assert torch.allclose(cum, torch.cumsum(dA, 0), rtol=1e-12)
    assert torch.allclose(after_k + torch.cumsum(dA, 0), total.expand(70),
                          rtol=1e-12)


def _parts(v, n):
    """v rounded to f32, then the sum of its first n bf16 parts (hi =
    bf16(v), then bf16 of what each leaves), in float64: the operand a
    product sees when the kernel issues it once per part."""
    out = torch.zeros_like(v, dtype=torch.float64)
    rest = v.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out += p.double()
        rest = rest - p
    return out


@pytest.mark.parametrize("parts,holds", [(1, False), (2, True), (3, True)])
def test_split_operands_hold_the_state_check(parts, holds):
    """Each f32 operand split into bf16 parts, every product exact
    (float64): one part, a single bf16 rounding, puts the final state past
    the checks' 1e-4 of the exact recurrence; two parts (~2^-17 of each
    operand) and three (~2^-24, f32's own) hold it, three within 1e-6."""
    args = _t(*_inputs(1, 96, 2, 8, 8, seed=5, bf16=True),
              dtype=torch.float64)
    _, th = _twin(*args, chunk=32, split=lambda v: _parts(v, parts))
    _, rh = _recurrence(*args)
    assert (_err(th, rh) <= 1e-4) == holds
    if parts == 3:
        assert _err(th, rh) <= 1e-6
