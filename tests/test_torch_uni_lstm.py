"""The one-direction LSTM (``kernels/lstm_cell.lstm_sequence`` and
``models/lstm.lstm_layer``).

On the CPU: the port's ``lstm_layer`` plain path against the reference's
``lstm_layer(kernel_impl="jax")`` (f32: 1e-5 forward, 1e-4 gradients),
both directions, with ``lengths``; the plain fused layer equal to the two
plain passes; on fake tensors the plain path, with no launch.  On the
card (``gpu`` marker, skipped elsewhere): ``lstm_layer`` launching K1
once, and the one-direction launches of K1, K1-stash, K2, K1-chunk and
K3 against their plain versions (2e-2), and the bidirectional launches
equal to the two one-direction passes bit for bit, forward and
gradients, for inference, stash and chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import lstm_cell as LC  # noqa: E402
from repro_torch.models import lstm as LS  # noqa: E402

F32_FWD, F32_GRAD, BF16_TOL = 1e-5, 1e-4, 2e-2


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _direction(rng, D, H, dtype=np.float32):
    return {"wx": (rng.standard_normal((D, 4 * H)) * 0.3).astype(dtype),
            "wh": (rng.standard_normal((H, 4 * H)) * 0.3).astype(dtype),
            "b": (rng.standard_normal(4 * H) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("lengths", [None, (7, 4, 1)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_plain_matches_reference(reverse, lengths):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import lstm as JL

    B, T, D, H = 3, 7, 12, 16
    rng = np.random.default_rng(10 + reverse)
    p = _direction(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def jloss(p, x):
        y = JL.lstm_layer(p, x, lengths=None if lens is None
                          else jnp.asarray(lens), reverse=reverse,
                          kernel_impl="jax")
        return jnp.sum(y * dy), y
    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y_t = LS.lstm_layer(pt, xt, lengths=None if lens is None
                        else torch.tensor(lens), reverse=reverse)
    (y_t * torch.tensor(dy)).sum().backward()
    assert y_t.dtype == torch.float32 and y_t.shape == (B, T, H)
    assert _norm_err(y_t.detach(), y_j) <= F32_FWD
    for k in ("wx", "wh", "b"):
        assert _norm_err(pt[k].grad, g_j[0][k]) <= F32_GRAD, k
    assert _norm_err(xt.grad, g_j[1]) <= F32_GRAD
    if lengths is not None:
        for b, n in enumerate(lengths):
            assert not y_t[b, n:].any()


def _bf16_layer(seed, L, B, T, D, H, lengths):
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)
    ws = []
    for _ in range(2):
        ws += [w(L, D, 4 * H), w(L, H, 4 * H),
               torch.randn(L, 4 * H, generator=g) * 0.1]
    x = w(L, B, T, D, scale=1.0)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32))
    return ws, x, lens


def _fused_vs_passes(ws, x, lens, **kw):
    """(y, grads) of blstm_sequence and of the two lstm_sequence passes,
    under the same cotangent."""
    H = ws[1].shape[-2]
    g = torch.Generator().manual_seed(3)
    dy = torch.randn(*x.shape[:-1], 2 * H, generator=g).to(x.device,
                                                           torch.bfloat16)
    out = []
    for fused in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in ws + [x]]
        *w, xi = leaves
        if fused:
            y = LC.blstm_sequence(*w, xi, lens, **kw)
        else:
            y = torch.cat([
                LC.lstm_sequence(*w[:3], xi, lens, **kw),
                LC.lstm_sequence(*w[3:], xi, lens, reverse=True, **kw)],
                dim=-1)
        y.backward(dy)
        out.append((y.detach(), [t.grad for t in leaves]))
    return out


@pytest.mark.parametrize("seq_chunk", [0, 3])
def test_plain_fused_layer_equals_two_passes(seq_chunk):
    ws, x, lens = _bf16_layer(5, 2, 3, 7, 12, 16, [(7, 4, 1), (2, 7, 0)])
    (y_f, g_f), (y_p, g_p) = _fused_vs_passes(ws, x, lens,
                                              seq_chunk=seq_chunk)
    assert torch.equal(y_f, y_p)
    for a, b in zip(g_f, g_p):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fake_tensors_take_the_plain_path():
    """The dry-run's fake tensors run the plain scan, forward and
    backward, and launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    names = ("uni_launches", "uni_stash_launches", "uni_bwd_launches",
             "uni_chunk_launches", "uni_chunked_bwd_launches")
    n = [getattr(LC, k) for k in names]
    with FakeTensorMode():
        p = {"wx": torch.empty(12, 64, requires_grad=True),
             "wh": torch.empty(16, 64, requires_grad=True),
             "b": torch.empty(64, requires_grad=True)}
        x = torch.empty(2, 5, 12)
        for reverse in (False, True):
            y = LS.lstm_layer(p, x, lengths=torch.tensor([5, 2]),
                              reverse=reverse, seq_chunk=2)
            assert y.shape == (2, 5, 16)
            y.sum().backward()
            assert p["wh"].grad.shape == (16, 64)
    assert [getattr(LC, k) for k in names] == n


def test_one_direction_counts_half_the_clusters():
    """A resident launch of one direction runs L·ceil(B / rows) clusters:
    at the train-long shape (16 learners x 2 rows, T = 2000, 7 clusters
    at once on the H100) 3 waves against the bidirectional 5."""
    plan = LC.recur_plan(2, 2000, 512)
    assert plan.path == "resident" and plan.block_rows == 2
    assert LC.recur_waves(plan, 16, 2, 7) == 5
    assert LC.recur_waves(plan, 16, 2, 7, n_dir=1) == 3
    assert LC.recur_waves(plan, 1, 16, 7, n_dir=1) == 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        pytest.skip(f"kernels are built for sm_90a, device has {cap}")
    return torch.device("cuda")


UNI_SHAPES = [
    (1, 3, 7, 12, 16, None),
    (2, 9, 5, 33, 100, [(5, 1, 2, 3, 4, 5, 5, 4, 0)] * 2),
    (2, 3, 20, 40, 64, [(20, 7, 1), (0, 20, 13)]),     # resident forward
]


def _on(cuda, ws, x, lens):
    return ([w.to(cuda) for w in ws], x.to(cuda),
            None if lens is None else lens.to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,T,D,H,lengths", UNI_SHAPES)
def test_one_direction_kernels_match_plain_and_the_fused_launch(
        cuda, L, B, T, D, H, lengths, stash):
    ws, x, lens = _on(cuda, *_bf16_layer(B * 10 + H, L, B, T, D, H,
                                         lengths))
    y2 = LC.blstm_layer(*ws, x, lens)
    y2s, acts2, cseq2 = LC.blstm_layer_train(*ws, x, lens, stash=stash)
    g = torch.Generator().manual_seed(H)
    dy = torch.randn(L, B, T, 2 * H, generator=g).to(cuda, torch.bfloat16)
    dx2, grads2 = LC.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4], x, y2s,
                                     acts2, cseq2, dy, lens)
    dxs = []
    for d in range(2):
        wx, wh, b = ws[3 * d:3 * d + 3]
        rev = bool(d)
        n = (LC.uni_launches, LC.uni_stash_launches, LC.uni_bwd_launches)
        y1 = LC.lstm_layer(wx, wh, b, x, lens, reverse=rev)
        y1s, acts, cseq = LC.lstm_layer_train(wx, wh, b, x, lens,
                                              reverse=rev, stash=stash)
        sl = slice(d * H, (d + 1) * H)
        dx, grads = LC.lstm_layer_bwd(wx, wh, x, y1s, acts, cseq,
                                      dy[..., sl].contiguous(), lens,
                                      reverse=rev)
        torch.cuda.synchronize()
        assert (LC.uni_launches, LC.uni_stash_launches,
                LC.uni_bwd_launches) == tuple(v + 1 for v in n)
        # the plain versions
        want = LC.lstm_layer_train(wx, wh, b, x, lens, reverse=rev,
                                   stash=stash, plain=True)
        for got, w_ in zip((y1s, acts, cseq), want):
            assert got.dtype == w_.dtype and got.shape == w_.shape
            assert _norm_err(got.float().cpu(), w_.float().cpu()) <= BF16_TOL
        dx_w, grads_w = LC.lstm_layer_bwd(wx, wh, x, y1s, acts, cseq,
                                          dy[..., sl].contiguous(), lens,
                                          reverse=rev, plain=True)
        assert _norm_err(dx.float().cpu(), dx_w.float().cpu()) <= BF16_TOL
        for got, w_ in zip(grads, grads_w):
            assert _norm_err(got.cpu(), w_.cpu()) <= BF16_TOL
        # bit for bit the direction's half of the fused launches
        assert torch.equal(y1, y2[..., sl]) and torch.equal(y1s, y1)
        assert torch.equal(acts, acts2[d]) and torch.equal(cseq, cseq2[d])
        for got, w_ in zip(grads, grads2[d]):
            assert torch.equal(got, w_)
        dxs.append(dx)
    assert torch.equal(dxs[0] + dxs[1], dx2)


CHUNKED = [
    (1, 3, 7, 12, 16, 3, None),
    (2, 5, 40, 40, 64, 16, [(40, 1, 2, 39, 3), (17, 40, 0, 16, 33)]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("L,B,T,D,H,K,lengths", CHUNKED)
def test_one_direction_chunked_kernels_match_plain_and_the_fused_launch(
        cuda, L, B, T, D, H, K, lengths):
    ws, x, lens = _on(cuda, *_bf16_layer(B * 7 + H, L, B, T, D, H, lengths))
    y2, hb2, cb2 = LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K)
    g = torch.Generator().manual_seed(H + K)
    dy = torch.randn(L, B, T, 2 * H, generator=g).to(cuda, torch.bfloat16)
    dx2, grads2 = LC.blstm_layer_bwd_chunked(*ws, x, y2, hb2, cb2, dy, lens,
                                             chunk=K)
    dxs = []
    for d in range(2):
        wx, wh, b = ws[3 * d:3 * d + 3]
        rev = bool(d)
        sl = slice(d * H, (d + 1) * H)
        n = (LC.uni_chunk_launches, LC.uni_chunked_bwd_launches)
        y, hb, cb = LC.lstm_layer_train_chunked(wx, wh, b, x, lens, chunk=K,
                                                reverse=rev)
        dyd = dy[..., sl].contiguous()
        dx, grads = LC.lstm_layer_bwd_chunked(wx, wh, b, x, y, hb, cb, dyd,
                                              lens, chunk=K, reverse=rev)
        torch.cuda.synchronize()
        assert (LC.uni_chunk_launches, LC.uni_chunked_bwd_launches) == (
            n[0] + 1, n[1] + 1)
        want = LC.lstm_layer_train_chunked(wx, wh, b, x, lens, chunk=K,
                                           reverse=rev, plain=True)
        for got, w_ in zip((y, hb, cb), want):
            assert got.shape == w_.shape
            assert _norm_err(got.float().cpu(), w_.float().cpu()) <= BF16_TOL
        dx_w, grads_w = LC.lstm_layer_bwd_chunked(
            wx, wh, b, x, y, hb, cb, dyd, lens, chunk=K, reverse=rev,
            plain=True)
        assert _norm_err(dx.float().cpu(), dx_w.float().cpu()) <= BF16_TOL
        for got, w_ in zip(grads, grads_w):
            assert _norm_err(got.cpu(), w_.cpu()) <= BF16_TOL
        assert torch.equal(y, y2[..., sl])
        assert torch.equal(hb, hb2[d]) and torch.equal(cb, cb2[d])
        for got, w_ in zip(grads, grads2[d]):
            assert torch.equal(got, w_)
        dxs.append(dx)
    assert torch.equal(dxs[0] + dxs[1], dx2)


@pytest.mark.gpu
@pytest.mark.parametrize("seq_chunk", [0, 16])
def test_fused_sequence_equals_two_passes_on_the_card(cuda, seq_chunk):
    ws, x, lens = _on(cuda, *_bf16_layer(9, 2, 5, 40, 40, 64,
                                         [(40, 1, 2, 39, 3),
                                          (17, 40, 0, 16, 33)]))
    (y_f, g_f), (y_p, g_p) = _fused_vs_passes(ws, x, lens,
                                              seq_chunk=seq_chunk)
    assert torch.equal(y_f, y_p)
    for a, b in zip(g_f, g_p):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_lstm_layer_on_the_card(cuda):
    rng = np.random.default_rng(2)
    p = {k: torch.tensor(v).to(torch.bfloat16 if k != "b" else
                               torch.float32)
         for k, v in _direction(rng, 12, 16).items()}
    x = torch.tensor(rng.standard_normal((2, 5, 12))).to(torch.bfloat16)
    n = LC.uni_launches
    y_k = LS.lstm_layer({k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    assert LC.uni_launches == n + 1
    y_p = LS.lstm_layer(p, x)                    # the plain scan, CPU
    assert _norm_err(y_k.float().cpu(), y_p.float()) <= BF16_TOL
