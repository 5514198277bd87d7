"""The port's CTC prefix beam search held against ``repro.decode.beam`` on
the CPU.

Same numpy inputs to both packages.  Under the ``max`` semiring the
frame step is bit-identical (selections and scores); under ``sum`` the
scores agree to 1e-5, since ``logaddexp``/``logsumexp`` are separate
implementations in the two frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.decode import beam as JB  # noqa: E402
from repro_torch.decode import beam as TB  # noqa: E402
from repro_torch.decode import kernel as TK  # noqa: E402

SUM_TOL = 1e-5


def _jax_state(rng, B, K, V, U, frames):
    """A realistic mid-utterance beam state: a few frames of JAX decode
    over peaked random posteriors (so prefixes merge)."""
    logits = rng.normal(size=(B, frames, V)).astype(np.float32) * 3.0
    st = JB.init_state(B, K, U)
    return JB.decode_chunk(st, jnp.asarray(logits))


def _step_args(state):
    return [np.array(a) for a in (state.p_b, state.p_nb, state.last,
                                  state.phash, state.lens)]


def _run_both(logp, args, *, semiring, max_len, topc):
    kw = dict(blank=0, max_len=max_len, semiring=semiring)
    if topc:
        want = JB.frame_step_scores_topc(jnp.asarray(logp),
                                         *map(jnp.asarray, args), topc=topc,
                                         **kw)
    else:
        want = JB.frame_step_scores(jnp.asarray(logp),
                                    *map(jnp.asarray, args), **kw)
    got = TK.beam_frame_step(torch.from_numpy(logp),
                             *map(torch.from_numpy, args), topc=topc, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_step_equal(want, got, semiring):
    (ws, wpb, wpnb), (gs, gpb, gpnb) = want, got
    assert gs.dtype == np.int32
    np.testing.assert_array_equal(gs, ws)
    if semiring == "max":
        np.testing.assert_array_equal(gpb, wpb)
        np.testing.assert_array_equal(gpnb, wpnb)
    else:
        np.testing.assert_allclose(gpb, wpb, rtol=SUM_TOL, atol=SUM_TOL)
        np.testing.assert_allclose(gpnb, wpnb, rtol=SUM_TOL, atol=SUM_TOL)


@pytest.mark.parametrize("semiring", ["max", "sum"])
@pytest.mark.parametrize("topc", [0, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_frame_step_matches_jax(semiring, topc, seed):
    rng = np.random.default_rng(seed)
    B, K, V, U = 3, 4, 9, 6
    state = _jax_state(rng, B, K, V, U, frames=4)
    logp = np.log(rng.dirichlet(np.full(V, 0.3), size=B)).astype(np.float32)
    want, got = _run_both(logp, _step_args(state),
                          semiring=semiring, max_len=U, topc=topc)
    _assert_step_equal(want, got, semiring)


@pytest.mark.parametrize("semiring", ["max", "sum"])
@pytest.mark.parametrize("topc", [0, 3])
def test_frame_step_fewer_live_than_beam(semiring, topc):
    """Fewer than K live candidates: later argmax passes tie at NEG and
    return an already-taken index (the reference stamps, not removes)."""
    rng = np.random.default_rng(5)
    B, K, V = 2, 4, 6
    p_b = np.full((B, K), JB.NEG, np.float32)
    p_b[:, 0] = 0.0
    p_b[1, 2] = -1.5
    p_nb = np.full((B, K), JB.NEG, np.float32)
    last = np.full((B, K), -1, np.int32)
    last[1, 2] = 3
    phash = np.zeros((B, K), np.int32)
    plen = np.zeros((B, K), np.int32)
    plen[1, 2] = 1
    logp = np.log(rng.dirichlet(np.ones(V), size=B)).astype(np.float32)
    # max_len 0 caps every extend, so only the live prefixes' stays
    # remain; max_len 1 caps row 1's length-1 prefix only
    for max_len in (0, 1):
        want, got = _run_both(logp, [p_b, p_nb, last, phash, plen],
                              semiring=semiring, max_len=max_len, topc=topc)
        _assert_step_equal(want, got, semiring)
        if max_len == 0:                           # repeats happened
            assert all(len(set(r)) < K for r in want[0].tolist())


def test_hash_wraps_like_int32():
    h = np.array([2 ** 31 - 1, -2 ** 31, 123456789, -987654321], np.int32)
    c = np.array([5, 7, 31999, 0], np.int32)
    with np.errstate(over="ignore"):
        want = h * np.int32(TB.HASH_P) + c
    got = TB._hash_step(torch.from_numpy(h), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("semiring", ["max", "sum"])
@pytest.mark.parametrize("topc", [0, 5])
def test_beam_search_tokens_match_jax(semiring, topc):
    rng = np.random.default_rng(7)
    B, T, V, K = 3, 12, 10, 4
    logits = (rng.normal(size=(B, T, V)) * 3.0).astype(np.float32)
    lengths = np.asarray([12, 7, 3], np.int32)
    kw = dict(beam=K, semiring=semiring, topc=topc)
    wt, wl, ws = JB.beam_search(jnp.asarray(logits), jnp.asarray(lengths),
                                **kw)
    gt, gl, gs = TB.beam_search(logits, lengths, device="cpu", **kw)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


def test_finalize_len_norm_matches_jax():
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(2, 9, 7)) * 3.0).astype(np.float32)
    st = JB.decode_chunk(JB.init_state(2, 3, 9), jnp.asarray(logits))
    want = JB.finalize(st, len_norm=0.7)
    tst = TB.BeamState(*(torch.from_numpy(np.array(a)) for a in st))
    got = TB.finalize(tst, len_norm=0.7)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    np.testing.assert_array_equal(TB.beam_occupancy(tst).numpy(),
                                  np.asarray(JB.beam_occupancy(st)))


@pytest.mark.parametrize("topc", [0, 4])
def test_chunked_equals_one_shot(topc):
    rng = np.random.default_rng(9)
    B, T, V, K = 3, 11, 8, 3
    logits = torch.from_numpy(
        (rng.normal(size=(B, T, V)) * 3.0).astype(np.float32))
    lengths = torch.tensor([11, 6, 9], dtype=torch.int32)
    one = TB.decode_chunk(TB.init_state(B, K, T, "cpu"), logits, lengths,
                          topc=topc)
    st = TB.init_state(B, K, T, "cpu")
    for s in range(0, T, 4):
        st = TB.decode_chunk(st, logits[:, s:s + 4], lengths, topc=topc)
    for a, b in zip(one, st):
        assert torch.equal(a, b)


def test_gather_scatter_round_trip():
    state = TB.init_state(4, 3, 10, "cpu")
    state = state._replace(p_b=state.p_b + torch.arange(4.0)[:, None],
                           t=torch.arange(4, dtype=torch.int32))
    rows = TB.gather_rows(state, [2])
    assert rows.p_b.shape[0] == 1 and int(rows.t[0]) == 2
    out = TB.scatter_rows(TB.init_state(4, 3, 10, "cpu"), rows, [2])
    for a, b in zip(out, state):
        assert torch.equal(a[2], b[2])
    fresh = TB.init_state(4, 3, 10, "cpu")
    for a, b in zip(out, fresh):
        assert torch.equal(a[0], b[0])              # other rows untouched


def test_reset_rows_matches_jax():
    rng = np.random.default_rng(10)
    logits = (rng.normal(size=(3, 5, 6)) * 3.0).astype(np.float32)
    st = JB.decode_chunk(JB.init_state(3, 3, 5), jnp.asarray(logits))
    mask = np.asarray([False, True, False])
    want = JB.reset_rows(st, jnp.asarray(mask))
    tst = TB.BeamState(*(torch.from_numpy(np.array(a)) for a in st))
    got = TB.reset_rows(tst, torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
