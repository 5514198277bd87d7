"""The LM slice's kernels — K6 argmax, K7 decode attention and K8 paged
decode attention — as the port runs them on the CPU (their plain
versions), held against the JAX package's Pallas kernels in interpret
mode, and the port's torch copy of the jnp decode math held against
``repro.models.attention``.

Tolerances (docs/kernels.md §Oracle tolerances): f32 1e-5 and bf16 2e-2,
normalised by the reference's max-abs; the argmax bit for bit.  Inputs
are drawn with numpy from a seed and handed to both packages.  Every
grid holds M = 3 (6 heads over 2 KV heads, smollm-360m's group) beside
M = 1, since the reduced config has M = 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.decode.kernel import argmax_tokens as jax_argmax  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jax_decode_attention,
    paged_decode_attention as jax_paged_decode_attention)
from repro.models import attention as JA  # noqa: E402
from repro_torch.decode import kernel as DK  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KV, E = 2, 16


def _arrays(seed, B, S, M, dtype, n_pages=None, P=None, E=E):
    rng = np.random.default_rng(seed)
    H = KV * M
    cache = (n_pages, P) if n_pages else (B, S)
    a = dict(q=rng.standard_normal((B, 1, H, E)),
             k=rng.standard_normal(cache + (KV, E)),
             v=rng.standard_normal(cache + (KV, E)),
             kn=rng.standard_normal((B, 1, KV, E)),
             vn=rng.standard_normal((B, 1, KV, E)))
    jx = {k: jnp.asarray(v.astype(np.float32)).astype(dtype)
          for k, v in a.items()}
    tt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in jx.items()}
    return jx, tt


def _err(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# K7: the plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("S,block_s,window", [(40, 16, None), (33, 16, 7)])
def test_decode_attention_plain_matches_pallas(S, block_s, window, M, delta,
                                               dtype):
    """Ragged S (33 over 16-row tiles), pos at 0, on a tile edge and at
    S - 1, with and without a window."""
    jx, tt = _arrays(S * 10 + M, 2, S, M, dtype)
    extra_j = dict(k_new=jx["kn"], v_new=jx["vn"]) if delta else {}
    extra_t = dict(k_new=tt["kn"], v_new=tt["vn"]) if delta else {}
    for pos in (0, block_s, S - 1):
        want = jax_decode_attention(jx["q"], jx["k"], jx["v"], pos,
                                    window=window, block_s=block_s,
                                    interpret=True, **extra_j)
        got = DA.decode_attention(tt["q"], tt["k"], tt["v"], pos,
                                  window=window, block_s=block_s, **extra_t)
        assert got.dtype == tt["q"].dtype and got.shape == tt["q"].shape
        assert _err(got, want) <= TOL[dtype], (pos, _err(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("M,E_,S", [(1, 64, 100), (4, 160, 40)])
def test_decode_attention_plain_matches_pallas_wide(S, E_, M, delta, dtype):
    """whisper-large-v3's decode shape (MHA, M = 1, E = 64): its cross-
    attention reads the whole cache at pos S - 1 (canonical), its self-
    attention the delta variant; and stablelm-12b's (M = 4, E = 160)."""
    jx, tt = _arrays(S + E_ + M, 2, S, M, dtype, E=E_)
    extra_j = dict(k_new=jx["kn"], v_new=jx["vn"]) if delta else {}
    extra_t = dict(k_new=tt["kn"], v_new=tt["vn"]) if delta else {}
    for pos, window in ((0, None), (17, None), (S - 1, None), (S - 1, 9)):
        want = jax_decode_attention(jx["q"], jx["k"], jx["v"], pos,
                                    window=window, block_s=16,
                                    interpret=True, **extra_j)
        got = DA.decode_attention(tt["q"], tt["k"], tt["v"], pos,
                                  window=window, block_s=16, **extra_t)
        assert got.shape == tt["q"].shape
        assert _err(got, want) <= TOL[dtype], (pos, _err(got, want))


def test_plain_delta_equals_write_then_attend():
    """Within the port: the delta variant over the old cache equals the
    canonical variant over the cache with the new token written."""
    _, tt = _arrays(5, 2, 24, 3, "float32")
    for pos in (0, 7, 23):
        for window in (None, 5):
            delta = DA.decode_attention(tt["q"], tt["k"], tt["v"], pos,
                                        window=window, k_new=tt["kn"],
                                        v_new=tt["vn"])
            kc = TA.update_cache(tt["k"], tt["kn"], pos)
            vc = TA.update_cache(tt["v"], tt["vn"], pos)
            canon = DA.decode_attention(tt["q"], kc, vc, pos, window=window)
            assert _err(delta, canon.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# K8: paged plain version vs the Pallas paged kernel, and vs K7's
# ---------------------------------------------------------------------------

def _shuffled_table(rng, B, W, n_pages, used):
    """Each row gets ``used`` distinct pages in shuffled order, padded to
    W with arbitrary valid page ids (never read: they lie above pos)."""
    perm = rng.permutation(n_pages)
    tbl = rng.integers(0, n_pages, size=(B, W))
    for b in range(B):
        tbl[b, :used] = perm[b * used:(b + 1) * used]
    return tbl.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("M", [1, 3])
def test_paged_plain_matches_pallas(M, delta, dtype):
    B, P, W, n_pages, used = 2, 8, 8, 24, 5
    jx, tt = _arrays(40 + M, B, None, M, dtype, n_pages=n_pages, P=P)
    rng = np.random.default_rng(7)
    tbl = _shuffled_table(rng, B, W, n_pages, used)
    extra_j = dict(k_new=jx["kn"], v_new=jx["vn"]) if delta else {}
    extra_t = dict(k_new=tt["kn"], v_new=tt["vn"]) if delta else {}
    for pos, window in ((0, None), (P, 6), (19, None), (used * P - 1, 6)):
        want = jax_paged_decode_attention(
            jx["q"], jx["k"], jx["v"], jnp.asarray(tbl), pos, window=window,
            interpret=True, **extra_j)
        got = DA.paged_decode_attention(
            tt["q"], tt["k"], tt["v"], torch.from_numpy(tbl), pos,
            window=window, **extra_t)
        assert _err(got, want) <= TOL[dtype], (pos, window)


def test_paged_plain_equals_dense_plain_bit_for_bit():
    """Within the port: the paged plain version over a shuffled, padded
    table equals the dense plain version over the same content laid out
    contiguously, bit for bit — and changing the padding entries changes
    nothing."""
    B, P, W, n_pages, used, M = 3, 4, 8, 40, 6, 3
    _, tt = _arrays(11, B, None, M, "bfloat16", n_pages=n_pages, P=P)
    rng = np.random.default_rng(3)
    tbl = torch.from_numpy(_shuffled_table(rng, B, W, n_pages, used))
    dense_k = DA.gather_pages(tt["k"], tbl[:, :used])
    dense_v = DA.gather_pages(tt["v"], tbl[:, :used])
    other = tbl.clone()
    other[:, used:] = (other[:, used:] + 1) % n_pages
    for pos in (0, 3, 4, 13, used * P - 1):
        for delta in (False, True):
            kw = dict(k_new=tt["kn"], v_new=tt["vn"]) if delta else {}
            paged = DA.paged_decode_attention(tt["q"], tt["k"], tt["v"], tbl,
                                              pos, **kw)
            dense = DA.decode_attention(tt["q"], dense_k, dense_v, pos, **kw)
            assert torch.equal(paged, dense), (pos, delta)
            again = DA.paged_decode_attention(tt["q"], tt["k"], tt["v"],
                                              other, pos, **kw)
            assert torch.equal(again, paged)


# ---------------------------------------------------------------------------
# The port's copy of the jnp decode math vs repro.models.attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_jnp_decode_math_matches_jax(dtype, window):
    jx, tt = _arrays(21, 2, 30, 3, dtype)
    for pos in (0, 9, 29):
        want = JA.attn_decode_delta(jx["q"], jx["k"], jx["v"], jx["kn"],
                                    jx["vn"], jnp.int32(pos), window=window)
        got = TA.attn_decode_delta_ref(tt["q"], tt["k"], tt["v"], tt["kn"],
                                       tt["vn"], pos, window=window)
        assert _err(got, want) <= TOL[dtype], pos
        want = JA.attn_decode(jx["q"], jx["k"], jx["v"], jnp.int32(pos),
                              window=window)
        got = TA.attn_decode_ref(tt["q"], tt["k"], tt["v"], pos,
                                 window=window)
        assert _err(got, want) <= TOL[dtype], pos


@pytest.mark.parametrize("Sq,window", [(12, None), (12, 4), (24, None)])
def test_attn_seq_matches_jax(Sq, window):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 6, E)).astype(np.float32)
    k = rng.standard_normal((2, Sq, KV, E)).astype(np.float32)
    v = rng.standard_normal((2, Sq, KV, E)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
        want = JA.attn_seq(jq, jk, jv, causal=True, window=window,
                           q_chunk=12)
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, dtype)) for a in (jq, jk, jv))
        got = TA.attn_seq(tq, tk, tv, causal=True, window=window, q_chunk=12)
        assert _err(got, want) <= TOL[dtype], dtype


def test_attn_decode_dispatches_to_the_wrappers():
    """On CPU tensors the model's decode attention is the wrappers' plain
    path, and no kernel launch is counted."""
    _, tt = _arrays(2, 2, 20, 3, "bfloat16")
    before = (DA.launches, DA.paged_launches)
    got = TA.attn_decode_delta(tt["q"], tt["k"], tt["v"], tt["kn"], tt["vn"],
                               9)
    want = DA.decode_attention_ref(tt["q"], tt["k"], tt["v"], 9,
                                   k_new=tt["kn"], v_new=tt["vn"])
    assert torch.equal(got, want)
    assert (DA.launches, DA.paged_launches) == before


# ---------------------------------------------------------------------------
# K6: argmax, bit for bit
# ---------------------------------------------------------------------------

def _argmax_rows(V, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, V)).astype(np.float32)
    x[1, [5, 17, V - 1]] = 9.0                  # a three-way tie
    x[2, [3, 40]] = np.nan                      # NaNs: the first wins
    x[2, 10] = np.inf
    x[3] = -np.inf                              # all -inf -> index 0
    x[4] = 0.0
    x[4, [7, 8]] = -0.0                         # +0 == -0: index 0
    x[5, V // 2] = np.inf
    x[6] = np.round(x[6] * 4) / 4               # many bf16 ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [61, 512, 4099])
def test_argmax_plain_matches_pallas_bit_for_bit(V, dtype):
    x = _argmax_rows(V, V)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_argmax(jx, interpret=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = DK.argmax_launches
    got = DK.argmax_tokens(tx)
    assert got.dtype == torch.int32 and DK.argmax_launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argmax(jx, axis=-1)))
