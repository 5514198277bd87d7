"""The K11 port's plain version and the repaired prefill attention, held
against the JAX package on the CPU.

``flash_attention_plain`` (the CPU path of the K11 wrapper and the card's
oracle) against ``repro.kernels.ref.attention_ref`` over the JAX kernel
test's own grid (MHA, GQA 3:1, MQA at E 128; window 0 and 64; bf16 and
f32; non-causal), plus what the port adds: ragged Sq, ``q_offset`` with
Sk > Sq, and the model's ``GLOBAL_WINDOW``.  Tolerances (normalised by
the reference's max-abs): f32 2e-5, bf16 2e-2 (one output rounding).

The port's ``attn_seq`` takes any Sq (a masked ragged last chunk): at Sq
= 600 it equals the reference's ``attn_seq(..., q_chunk=600)``, which
the reference accepts as one chunk (its default q_chunk 512 asserts).
Both LM servers at the reduced ``smollm-360m`` admit a 600-token prompt
and decode it.

The kernel's launch plan (``flash_attention.plan``): at every item size
it may choose, every admitted (row, key) pair lies in exactly one item's
rows and key walk (the kernel's key range, mirrored by ``_tile_keys``)
and items run heaviest first; the sizes it picks at the serving shapes;
and the kernel's algorithm emulated in f32 (each
item's online softmax tile by tile, a 64-row item's two walkers merged
by the log-sum-exp rule) against ``flash_attention_plain`` at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.transformer import GLOBAL_WINDOW  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


def _inputs(B, Sq, Sk, H, KV, E, dtype, seed):
    """The same values for both packages: numpy draws rounded once to
    ``dtype`` through JAX, handed to torch as f32 and cast back."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, E), (B, Sk, KV, E), (B, Sk, KV, E))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _check_plain(B, Sq, Sk, H, KV, E, dtype, *, causal=True, window=0,
                 q_offset=0, seed=0):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Sk, H, KV, E, dtype, seed)
    want = JR.attention_ref(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_offset)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(want, got) <= TOL[dtype]
    return tq, tk, tv, got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,H,KV,E", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 6, 2, 64),      # GQA 3:1
    (1, 256, 8, 1, 128),     # MQA, 128 head_dim
])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_matches_jax_reference(B, S, H, KV, E, dtype, window):
    _check_plain(B, S, S, H, KV, E, dtype, window=window, seed=S + H)


def test_plain_noncausal_matches_jax_reference():
    _check_plain(2, 128, 128, 4, 4, 64, "bfloat16", causal=False, seed=4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sq,window", [(1, 0), (100, 0), (100, 64),
                                        (600, 0), (600, 64)])
def test_plain_ragged_sq_matches_jax_reference(Sq, window, dtype):
    """Prompt lengths that are no multiple of any block (the Pallas kernel
    asserts Sq % block_q == 0), GQA groups of 5 as in hymba-1.5b."""
    _check_plain(1, Sq, Sq, 10, 2, 64, dtype, window=window, seed=Sq)


@pytest.mark.parametrize("window", [0, 48])
def test_plain_q_offset_matches_jax_reference(window):
    """A chunk of 37 queries at positions 90..126 against 127 keys."""
    _check_plain(2, 37, 127, 6, 2, 64, "float32", window=window, q_offset=90,
                 seed=7)


def test_global_window_is_full_attention():
    tq, tk, tv, full = _check_plain(1, 70, 70, 4, 2, 64, "float32", seed=8)
    glob = flash_attention_plain(tq, tk, tv, window=int(GLOBAL_WINDOW))
    assert torch.equal(glob, full)
    # None is no window, as in the wrapper (the encdec layers pass it)
    assert torch.equal(flash_attention_plain(tq, tk, tv, window=None), full)
    assert FA.kernel_window(GLOBAL_WINDOW, causal=True, q_offset=0,
                            Sq=70) == 0
    assert FA.kernel_window(69, causal=True, q_offset=0, Sq=70) == 69
    assert FA.kernel_window(70, causal=True, q_offset=0, Sq=70) == 0
    assert FA.kernel_window(None, causal=True, q_offset=0, Sq=70) == 0
    assert FA.kernel_window(16, causal=False, q_offset=0, Sq=70) == 0


def test_wrapper_runs_the_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any other
    device reaches the kernel's checks, never the plain path."""
    _, (tq, tk, tv) = _inputs(1, 20, 20, 4, 2, 64, "bfloat16", 9)
    before = FA.launches
    got = FA.flash_attention(tq, tk, tv, window=8)
    assert torch.equal(got, flash_attention_plain(tq, tk, tv, window=8))
    assert FA.launches == before

    def meta(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16, device="meta")

    q, kv = meta(1, 20, 4, 64), meta(1, 20, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim 48"):
        FA.flash_attention(meta(1, 20, 4, 48), meta(1, 20, 2, 48),
                           meta(1, 20, 2, 48))
    with pytest.raises(ValueError, match="multiple of KV"):
        FA.flash_attention(meta(1, 20, 5, 64), kv, kv)
    with pytest.raises(ValueError, match="admits no key"):
        FA.flash_attention(q, meta(1, 4, 2, 64), meta(1, 4, 2, 64),
                           window=8, q_offset=10)
    assert FA.launches == before


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_seq_ragged_chunk_matches_jax(dtype, window):
    """Sq = 600: the port chunks it 512 + 88 (masked ragged chunk), the
    reference takes it as one chunk of 600; at 512 the reference's
    default asserts ``(600, 512)``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 600, 600, 6, 2, 64, dtype, 10)
    with pytest.raises(AssertionError):
        JA.attn_seq(jq, jk, jv, causal=True, window=window)
    want = JA.attn_seq(jq, jk, jv, causal=True, window=window, q_chunk=600)
    got = TA.attn_seq(tq, tk, tv, causal=True, window=window)
    assert _err(want, got) <= TOL[dtype]
    one = TA.attn_seq(tq, tk, tv, causal=True, window=window, q_chunk=600)
    assert torch.equal(got, one)          # chunking changes no value
    assert torch.equal(TA.attn_prefill(tq, tk, tv, window=window), got)


def _smollm():
    return get_arch("smollm-360m").reduced()


@pytest.mark.parametrize("paged", [False, True])
def test_servers_admit_a_600_token_prompt(paged):
    """Both servers admit a 600-token prompt at max_len 1024 (before the
    repair, ``attn_seq`` raised ``AssertionError: (600, 512)``; the paged
    server from 513 tokens on, its prefill rounded up to whole pages) and
    decode it; the paged run decodes the dense run's tokens."""
    cfg = _smollm()
    pending = TS.lm_requests(cfg, [600, 37])

    def serve(server):
        finished, _, _, _ = TS.serve_lm(server, pending, 4)
        return dict(finished)

    dense = serve(TS.Server(cfg, slots=2, max_len=1024, device="cpu"))
    assert sorted(dense) == [0, 1]
    assert all(len(t) == 4 for t in dense.values())
    if paged:
        got = serve(TS.PagedServer(cfg, pool_pages=128, page_size=16,
                                   max_len=1024, device="cpu"))
        assert got == dense


# ---------------------------------------------------------------------------
# the kernel's launch plan: row tiles, key splits, launch order
# ---------------------------------------------------------------------------

def _admitted(Sq, Sk, M, causal, window, q_offset):
    """(Sq * M, Sk) bool: the keys each flattened (position, head) row
    admits (``window`` as ``kernel_window`` gives it: 0 is none)."""
    p = q_offset + np.arange(Sq * M) // M
    t = np.arange(Sk)
    ok = np.ones((Sq * M, Sk), bool)
    if causal:
        ok &= t[None, :] <= p[:, None]
        if window > 0:
            ok &= p[:, None] - t[None, :] < window
    return ok


def _tile_keys(tile, rows, *, Sq, Sk, M, causal, window, q_offset):
    """[kt0, kt1): the key tiles row tile ``tile`` of ``rows`` rows
    visits, as the kernel computes them: those of [lo, hi) of its first
    and last positions (``window`` as ``kernel_window`` gives it)."""
    r0, r_end = tile * rows, min((tile + 1) * rows, Sq * M)
    p_first, p_last = r0 // M + q_offset, (r_end - 1) // M + q_offset
    hi = min(Sk, p_last + 1) if causal else Sk
    lo = max(p_first - window + 1, 0) if causal and window > 0 else 0
    return lo // FA.BK, -(-hi // FA.BK)


def _items(pl, *, B, Sq, Sk, KV, M, causal, window, q_offset):
    """The items of plan ``pl`` in launch (block) order, as the kernel
    decodes a block index: dicts of b, g, tile, rows [r0, r1) of the
    flattened (position, head) rows of (b, g), and keys [k0, k1) its walk
    visits."""
    out = []
    for item in range(pl.items):
        g, rest = item % KV, item // KV
        b, tile = rest % B, pl.tiles - 1 - rest // B
        kt0, kt1 = _tile_keys(tile, pl.rows, Sq=Sq, Sk=Sk, M=M,
                                causal=causal, window=window,
                                q_offset=q_offset)
        out.append(dict(b=b, g=g, tile=tile,
                        rows=(tile * pl.rows,
                              min((tile + 1) * pl.rows, Sq * M)),
                        keys=(kt0 * FA.BK, kt1 * FA.BK)))
    return out


PLAN_CASES = [  # B, Sq, Sk, KV, M, causal, window, q_offset, sms
    (1, 1500, 1500, 5, 5, True, 1024, 0, 132),    # hymba windowed
    (1, 1500, 1500, 5, 5, True, 0, 0, 132),       # hymba global
    (1, 600, 600, 5, 3, True, 0, 0, 132),         # smollm-360m: split
    (1, 700, 700, 8, 3, True, 0, 0, 132),         # granite-moe
    (2, 77, 77, 2, 3, True, 16, 0, 132),
    (1, 130, 500, 5, 5, True, 64, 370, 132),      # q_offset, Sk > Sq
    (2, 37, 300, 5, 3, True, 0, 263, 8),
    (2, 333, 290, 2, 4, False, 0, 0, 132),        # non-causal, Sk < Sq
    (1, 777, 777, 1, 8, True, 128, 0, 132),
    (1, 200, 200, 1, 8, True, 0, 0, 16),
    (3, 65, 65, 3, 1, True, 0, 0, 132),           # MHA
    (1, 300, 300, 1, 1, True, 64, 0, 4),
    (1, 1, 1, 2, 2, True, 0, 0, 132),
]


@pytest.mark.parametrize("B,Sq,Sk,KV,M,causal,window,q_offset,sms",
                         PLAN_CASES)
def test_plan_covers_every_admitted_pair_once(B, Sq, Sk, KV, M, causal,
                                              window, q_offset, sms):
    """Under every item size the rule chooses from: every admitted (row,
    key) pair of every (batch, KV head) lies in exactly one item's rows
    and key walk; no item walks outside the key tiles of its rows' [lo,
    hi); items run heaviest first."""
    rule = FA.plan(B, Sq, KV, M, 64, sms)
    ok = _admitted(Sq, Sk, M, causal, window, q_offset)
    plans = [FA.Plan(rows, -(-Sq * M // rows), -(-Sq * M // rows) * B * KV)
             for rows in FA.ITEM_ROWS]
    assert rule in plans
    for pl in plans:                      # the rule's and the others
        _check_items(pl, ok, B, Sq, Sk, KV, M, causal, window, q_offset)


def _check_items(pl, ok, B, Sq, Sk, KV, M, causal, window, q_offset):
    items = _items(pl, B=B, Sq=Sq, Sk=Sk, KV=KV, M=M, causal=causal,
                          window=window, q_offset=q_offset)
    assert len(items) == pl.items == pl.tiles * B * KV
    assert len({(i["b"], i["g"], i["tile"]) for i in items}) == pl.items
    cover = np.zeros((B, KV) + ok.shape, np.int32)
    for i in items:
        (r0, r1), (k0, k1) = i["rows"], i["keys"]
        assert 0 <= r0 < r1 <= Sq * M and r1 - r0 <= pl.rows
        assert k0 % FA.BK == 0 and k1 % FA.BK == 0 and k0 <= k1
        if k1 > k0:
            rows = ok[r0:r1]
            seen = np.flatnonzero(rows.any(0))
            assert k0 >= seen.min() // FA.BK * FA.BK
            assert k1 <= -(-(seen.max() + 1) // FA.BK) * FA.BK
        cover[i["b"], i["g"], r0:r1, k0:min(k1, Sk)] += 1
    assert np.array_equal(cover * ok, np.broadcast_to(ok, cover.shape))
    tiles = [i["tile"] for i in items]
    assert tiles == sorted(tiles, reverse=True)


def test_plan_sizes_items_by_the_grid():
    """hymba's prefill takes 192-row items (200 of them on 132 SMs);
    granite's 136 items of 128 fill the card; smollm-360m's S = 600 would
    give 75 items of 128 and takes 145 of 64 rows, their chains walked by
    two warpgroups, as does 8 heads over one KV head at S = 1500 (94 of
    128); E = 128 never takes 192 rows; more SMs never take larger
    items."""
    assert FA.plan(1, 1500, 5, 5, 64, 132) == FA.Plan(192, 40, 200)
    assert FA.plan(1, 700, 8, 3, 64, 132) == FA.Plan(128, 17, 136)
    assert FA.plan(1, 600, 5, 3, 64, 132) == FA.Plan(64, 29, 145)
    assert FA.plan(1, 1500, 1, 8, 64, 132).rows == 64
    assert FA.plan(1, 1500, 5, 5, 128, 132) == FA.Plan(128, 59, 295)
    assert FA.plan(1, 1, 2, 2, 64, 132) == FA.Plan(64, 1, 2)
    rows = [FA.plan(1, 1500, 5, 5, 64, sms).rows
            for sms in (16, 132, 200, 201, 296, 1024)]
    assert rows == [192, 192, 192, 128, 64, 64]


def _emulate_items(q, k, v, pl, *, causal, window, q_offset):
    """The kernel's algorithm in f32 torch ops: each item walks its key
    tiles with the online softmax (scores in the log2 domain, masked ones
    -1e30, keys past Sk zero rows, masked); a 64-row item's two walkers
    take alternate tiles and their partials (acc, m, l) merge by the
    log-sum-exp rule; o = acc / max(l, 1e-30)."""
    B, Sq, H, E = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    M = H // KV
    c = (1.0 / np.sqrt(E)) * np.log2(np.e)
    ok = torch.from_numpy(_admitted(Sq, Sk, M, causal, window, q_offset))
    qf = q.float().reshape(B, Sq, KV, M, E).permute(0, 2, 1, 3, 4).reshape(
        B, KV, Sq * M, E)
    out = torch.empty(B, KV, Sq * M, E)
    walkers = 2 if pl.rows == 64 else 1      # 64 rows: a shared walk
    for i in _items(pl, B=B, Sq=Sq, Sk=Sk, KV=KV, M=M, causal=causal,
                           window=window, q_offset=q_offset):
        (r0, r1), (k0, k1) = i["rows"], i["keys"]
        b, g = i["b"], i["g"]
        parts = []
        for w in range(walkers):
            acc = torch.zeros(r1 - r0, E)
            m = torch.full((r1 - r0,), -1e30)
            l = torch.zeros(r1 - r0)
            for t0 in range(k0 + w * FA.BK, k1, walkers * FA.BK):
                kt, vt = torch.zeros(FA.BK, E), torch.zeros(FA.BK, E)
                n = max(0, min(t0 + FA.BK, Sk) - t0)
                kt[:n] = k[b, t0:t0 + n, g].float()
                vt[:n] = v[b, t0:t0 + n, g].float()
                mask = torch.zeros(r1 - r0, FA.BK, dtype=torch.bool)
                mask[:, :n] = ok[r0:r1, t0:t0 + n]
                s = torch.where(mask, qf[b, g, r0:r1] @ kt.T * c,
                                torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                acc = acc * alpha[:, None] + p @ vt
                l = l * alpha + p.sum(-1)
                m = m_new
            parts.append((acc, m, l))
        mx = torch.stack([m for _, m, _ in parts]).amax(0)
        w = [torch.exp2(m - mx) for _, m, _ in parts]
        acc = sum(a * wi[:, None] for (a, _, _), wi in zip(parts, w))
        den = sum(l * wi for (_, _, l), wi in zip(parts, w))
        out[b, g, r0:r1] = acc / den.clamp_min(1e-30)[:, None]
    return out.reshape(B, KV, Sq, M, E).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, E)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window,q_offset,rows", [
    (1, 300, 300, 15, 5, True, 0, 0, 64),         # smollm's heads
    (1, 100, 100, 4, 4, True, 0, 0, 64),          # a walker with no tile
    (2, 150, 150, 8, 2, True, 64, 0, 64),         # windowed
    (1, 100, 400, 6, 2, True, 0, 300, 64),        # q_offset, Sk > Sq
    (2, 90, 70, 8, 2, False, 0, 0, 64),           # non-causal
    (1, 200, 200, 25, 5, True, 0, 0, 128),
    (1, 200, 200, 25, 5, True, 48, 0, 192),
])
def test_item_walk_and_merge_emulation_matches_plain(B, Sq, Sk, H, KV,
                                                     causal, window,
                                                     q_offset, rows):
    """The items' online softmax and, for 64-row items, the two walkers'
    log-sum-exp merge give the attention (f32, 1e-5 of the largest
    value)."""
    _, (tq, tk, tv) = _inputs(B, Sq, Sk, H, KV, 64, "float32", Sq + H)
    tiles = -(-Sq * (H // KV) // rows)
    pl = FA.Plan(rows, tiles, tiles * B * KV)
    got = _emulate_items(tq, tk, tv, pl, causal=causal, window=window,
                         q_offset=q_offset)
    want = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                 q_offset=q_offset)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5
