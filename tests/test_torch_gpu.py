"""The port's CUDA kernels held against their plain PyTorch versions on
the card, at small and odd shapes (the full-width shapes are in
``chip_smoke.py``).  Every test needs a CUDA card of capability (9, 0)
and skips elsewhere; this file imports no JAX, so it runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

BF16_TOL = 2e-2
SUM_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        pytest.skip(f"kernels are built for sm_90a, device has {cap}")
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,D,H,lengths", [
    (3, 7, 12, 16, None),
    (3, 7, 12, 16, (7, 4, 1)),
    (5, 9, 40, 48, (9, 9, 3, 0, 6)),
    (9, 5, 33, 100, (5, 1, 2, 3, 4, 5, 5, 4, 3)),
])
def test_blstm_layer_kernel_matches_plain(cuda, B, T, D, H, lengths):
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import blstm_layer_ref

    g = torch.Generator().manual_seed(B * 100 + H)

    def w(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(
            cuda, torch.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(D, 4 * H), w(H, 4 * H),
               (torch.randn(4 * H, generator=g) * 0.1).to(cuda)]
    x = w(B, T, D, scale=1.0)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda))
    before = lstm_cell.launches
    got = lstm_cell.blstm_layer(*ws, x, lens)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1
    want = blstm_layer_ref(*ws, x, lens)
    scale = float(want.float().abs().max()) + 1e-8
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= BF16_TOL, err
    if lengths is not None:
        for b, n in enumerate(lengths):
            assert not got[b, n:].any()


def _stacked(cuda, L, B, T, D, H, lengths, seed):
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(
            cuda, torch.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(L, D, 4 * H), w(L, H, 4 * H),
               (torch.randn(L, 4 * H, generator=g) * 0.1).to(cuda)]
    x = w(L, B, T, D, scale=1.0)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda))
    return ws, x, lens


def _norm_err(got, want):
    scale = float(want.float().abs().max()) + 1e-8
    return float((got.float() - want.float()).abs().max()) / scale


# K4: the stack in one launch, bit-identical to the loop of K1 launches;
# B in a ragged tile, H not a multiple of 32, a length-0 row, learners,
# and B = 16: two 8-row tiles of K1's cluster recurrence against K4's
# own 8-row items
STACK_SHAPES = [
    (0, 5, 9, 12, 16, 3, (9, 4, 1, 9, 6)),
    (0, 1, 7, 20, 48, 2, None),
    (0, 2, 7, 20, 48, 3, (7, 3)),
    (0, 9, 5, 33, 100, 4, (5, 1, 2, 3, 4, 5, 5, 4, 0)),
    (3, 3, 6, 12, 16, 3, [(6, 2, 1), (1, 6, 3), (0, 4, 6)]),
    (0, 16, 6, 20, 48, 2, (6, 5, 4, 3, 2, 1, 0, 6, 6, 5, 4, 3, 2, 1, 6, 6)),
]


@pytest.mark.parametrize("L,B,T,D0,H,n_layers,lengths", STACK_SHAPES)
def test_blstm_stack_kernel_matches_loop_and_plain(cuda, L, B, T, D0, H,
                                                   n_layers, lengths):
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import blstm_stack_plain

    g = torch.Generator().manual_seed(B * 100 + H + n_layers)
    lead = (L,) if L else ()

    def w(*shape, scale=0.3):
        return (torch.randn(*lead, *shape, generator=g) * scale).to(
            cuda, torch.bfloat16)

    layers, D = [], D0
    for _ in range(n_layers):
        ws = []
        for _ in range(2):
            ws += [w(D, 4 * H), w(H, 4 * H),
                   (torch.randn(*lead, 4 * H, generator=g) * 0.1).to(cuda)]
        layers.append(ws)
        D = 2 * H
    x = w(B, T, D0, scale=1.0)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda))
    before = (lstm_cell.stack_launches, lstm_cell.launches)
    got = lstm_cell.blstm_stack(layers, x, lens)
    torch.cuda.synchronize()
    assert (lstm_cell.stack_launches, lstm_cell.launches) == \
        (before[0] + 1, before[1])
    loop = x
    for ws in layers:
        loop = lstm_cell.blstm_layer(*ws, loop, lens)
    assert torch.equal(got, loop)
    want = blstm_stack_plain(layers, x, lens)
    assert torch.isfinite(got).all()
    assert _norm_err(got, want) <= BF16_TOL


def _var_lens(L, B, T):
    """Lengths with a full row and a length-1 row (B > 1), per learner."""
    rows = [[T if b == 0 else 1 if b == 1 else T - (b * 53 + l * 7) % T
             for b in range(B)] for l in range(max(L, 1))]
    return rows if L else rows[0]


# K4 on its resident path (H a multiple of 64, clusters of 16 CTAs):
# every B from one cluster to several waves, T = 21 and 256, var-len with
# a length-1 row, the learner axis; H = 64 (4 units a CTA) too.  Weights
# at 1/sqrt(fan-in): at H = 512 the file's 0.3 saturates every gate and
# the plain version's other sum order drifts past any tolerance over 256
# steps, while K4 and the K1 loop keep their bits.
RESIDENT_STACK_SHAPES = [
    (L, B, T, 260, 512, 2) for B in (1, 3, 5, 8, 16) for T in (21, 256)
    for L in (0,)] + [
    (2, 8, 21, 260, 512, 2),
    (2, 1, 256, 260, 512, 3),
    (0, 5, 33, 40, 64, 3),
]


@pytest.mark.parametrize("L,B,T,D0,H,n_layers", RESIDENT_STACK_SHAPES)
def test_resident_stack_matches_loop_and_plain(cuda, L, B, T, D0, H,
                                               n_layers):
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import blstm_stack_plain

    active = lstm_cell.stack_active_clusters(H)
    plan = lstm_cell.stack_plan(B, H, active, max(L, 1))
    assert plan.path == "resident" and active >= 1, (plan, active)
    g = torch.Generator().manual_seed(B * 1000 + T + H + L)
    lead = (L,) if L else ()

    def w(*shape, scale):
        return (torch.randn(*lead, *shape, generator=g) * scale).to(
            cuda, torch.bfloat16)

    layers, D = [], D0
    for _ in range(n_layers):
        ws = []
        for _ in range(2):
            ws += [w(D, 4 * H, scale=D ** -0.5), w(H, 4 * H, scale=H ** -0.5),
                   (torch.randn(*lead, 4 * H, generator=g) * 0.1).to(cuda)]
        layers.append(ws)
        D = 2 * H
    x = w(B, T, D0, scale=1.0)
    lengths = _var_lens(L, B, T)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (lstm_cell.stack_launches, lstm_cell.launches)
    got = lstm_cell.blstm_stack(layers, x, lens)
    torch.cuda.synchronize()
    assert (lstm_cell.stack_launches, lstm_cell.launches) == \
        (before[0] + 1, before[1])
    loop = x
    for ws in layers:
        loop = lstm_cell.blstm_layer(*ws, loop, lens)
    assert torch.equal(got, loop)
    assert torch.isfinite(got).all()
    assert _norm_err(got, blstm_stack_plain(layers, x, lens)) <= BF16_TOL
    for l, row in enumerate(lengths if L else [lengths]):
        out = got[l] if L else got
        for b, n in enumerate(row):
            assert not out[b, n:].any()


def test_blstm_stack_rejects_a_missing_bias(cuda):
    from repro_torch.kernels import lstm_cell

    ws, x, lens = _stacked(cuda, 1, 2, 5, 12, 16, (5, 3), seed=3)
    layers = [[w[0] for w in ws]]
    layers[0][5] = None
    before = lstm_cell.stack_launches
    with pytest.raises(ValueError, match="layer 0"):
        lstm_cell.blstm_stack(layers, x[0], lens)
    assert lstm_cell.stack_launches == before


def test_forward_no_grad_launches_the_stack_once(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import lstm_cell
    from repro_torch.models.lstm import forward, param_specs
    from repro_torch.params import init_params

    cfg = get_arch("swb2000-blstm").reduced()
    params = init_params(param_specs(cfg), seed=0, device=cuda)
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(3, 8, cfg.input_dim, generator=g)
    lengths = torch.tensor([8, 5, 1], dtype=torch.int32)
    before = (lstm_cell.stack_launches, lstm_cell.launches)
    with torch.no_grad():
        got = forward(cfg, params, feats, lengths)
    torch.cuda.synchronize()
    assert (lstm_cell.stack_launches, lstm_cell.launches) == \
        (before[0] + 1, before[1])
    want = forward(cfg, params, feats, lengths, plain=True)
    assert _norm_err(got, want) <= BF16_TOL


# odd shapes: B not a multiple of the tile, H < 512 and not a multiple of
# 32, T = 1, a length-0 row, three learners; 17 rows per learner (two
# 8-row tiles and a ragged one of 1) split over clusters of 2 CTAs
TRAIN_SHAPES = [
    (1, 3, 7, 12, 16, None),
    (3, 3, 7, 12, 16, [(7, 4, 1), (0, 7, 3), (2, 2, 2)]),
    (2, 5, 1, 40, 48, [(1, 0, 1, 1, 1), (1, 1, 0, 1, 1)]),
    (3, 9, 5, 33, 100, [(5, 1, 2, 3, 4, 5, 5, 4, 0)] * 3),
    (2, 17, 5, 40, 48, [(5, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, 0, 5, 5, 2, 3, 4),
                        (4, 3, 2, 5, 5, 0, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, 5)]),
]


@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,T,D,H,lengths", TRAIN_SHAPES)
def test_blstm_stash_kernel_matches_plain(cuda, L, B, T, D, H, lengths,
                                          stash):
    from repro_torch.kernels import lstm_cell

    ws, x, lens = _stacked(cuda, L, B, T, D, H, lengths, seed=B * 10 + H)
    before = lstm_cell.stash_launches
    got = lstm_cell.blstm_layer_train(*ws, x, lens, stash=stash)
    torch.cuda.synchronize()
    assert lstm_cell.stash_launches == before + 1
    want = lstm_cell.blstm_layer_train(*ws, x, lens, stash=stash,
                                       plain=True)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert _norm_err(g_, w_) <= BF16_TOL
    assert torch.equal(got[0], lstm_cell.blstm_layer(*ws, x, lens))
    if lengths is not None:
        for l, row in enumerate(lengths):
            for b, n in enumerate(row):
                assert not got[0][l, b, n:].any()


@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,T,D,H,lengths", TRAIN_SHAPES)
def test_blstm_bwd_kernel_matches_plain(cuda, L, B, T, D, H, lengths, stash):
    from repro_torch.kernels import lstm_cell

    ws, x, lens = _stacked(cuda, L, B, T, D, H, lengths, seed=B * 10 + H + 1)
    g = torch.Generator().manual_seed(H)
    dy = torch.randn(L, B, T, 2 * H, generator=g).to(cuda, torch.bfloat16)
    y, acts, cseq = lstm_cell.blstm_layer_train(*ws, x, lens, stash=stash)
    args = (ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq, dy, lens)
    before = lstm_cell.bwd_launches
    dx, grads = lstm_cell.blstm_layer_bwd(*args)
    torch.cuda.synchronize()
    assert lstm_cell.bwd_launches == before + 1
    dx_w, grads_w = lstm_cell.blstm_layer_bwd(*args, plain=True)
    assert dx.dtype == torch.bfloat16 and _norm_err(dx, dx_w) <= BF16_TOL
    for d in range(2):
        for g_, w_ in zip(grads[d], grads_w[d]):
            assert g_.dtype == torch.float32 and g_.shape == w_.shape
            assert _norm_err(g_, w_) <= BF16_TOL
    if lengths is not None:           # padded steps get no dx
        for l, row in enumerate(lengths):
            for b, n in enumerate(row):
                assert not dx[l, b, n:].any()


# The tensor-core GEMM routine (csrc/gemm.cuh) through lstm_xproj,
# lstm_bwd_dx (its unrounded f32 view) and lstm_bwd_dw, against float64
# products: ragged M, N and K (none a multiple of the 128 x 128 x 16
# tile), M over two row tiles, the ShiftedRows boundary (h_prev zero at
# each sequence's first recurrence step), the ones row (db), and K = 4H =
# 2048 for dx.  The f32 dgates enter split into three bf16 parts; a single
# bf16 or TF32 pass would miss by ~1e-3.
PRECISION_TOL = 1e-5
PRECISION_SHAPES = [
    (2, 3, 7, 40, 20),
    (1, 17, 9, 136, 48),
    (1, 4, 50, 1024, 512),
]


@pytest.mark.parametrize("L,B,T,D,H", PRECISION_SHAPES)
def test_gemm_routine_matches_float64(cuda, L, B, T, D, H):
    from repro_torch.kernels import lstm_cell

    g = torch.Generator().manual_seed(L * 1000 + B * 10 + H)
    M, N = B * T, 4 * H

    def bf(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            cuda, torch.bfloat16)

    x = bf(L, B, T, D)
    wxf, wxb = bf(L, D, N, scale=D ** -0.5), bf(L, D, N, scale=D ** -0.5)
    y = bf(L, B, T, 2 * H)
    dg = torch.randn(2, L, M, N, generator=g).to(cuda)
    xm = x.double().view(L, M, D)
    gx = lstm_cell._xproj(x.view(L, M, D), wxf, wxb)
    for d, wx in enumerate((wxf, wxb)):
        assert _norm_err(gx[:, d], xm @ wx.double()) <= PRECISION_TOL
    dx = lstm_cell._bwd_dx(dg, wxf, wxb, f32_out=True)
    want = (dg[0].double() @ wxf.double().transpose(1, 2)
            + dg[1].double() @ wxb.double().transpose(1, 2))
    assert dx.dtype == torch.float32 and _norm_err(dx, want) <= PRECISION_TOL
    dwx, dwhb = lstm_cell._bwd_dw(x, y, dg)
    for d in range(2):
        assert _norm_err(dwx[d], xm.transpose(1, 2) @ dg[d].double()) <= \
            PRECISION_TOL
        h = y[..., d * H:(d + 1) * H].double()
        prev = torch.zeros_like(h)        # h_{t-1}: t - 1 forward, t + 1 back
        if d == 0:
            prev[:, :, 1:] = h[:, :, :-1]
        else:
            prev[:, :, :-1] = h[:, :, 1:]
        hp = torch.cat([prev.view(L, M, H),
                        torch.ones(L, M, 1, dtype=h.dtype, device=cuda)], -1)
        want = hp.transpose(1, 2) @ dg[d].double()
        assert _norm_err(dwhb[d, :, :H], want[:, :H]) <= PRECISION_TOL
        assert _norm_err(dwhb[d, :, H], want[:, H]) <= PRECISION_TOL


# chunked shapes: K dividing T, K not dividing T (padding), K > T (auto K
# of a short T), a length-1 row, rows with whole masked chunks
CHUNK_SHAPES = [
    (1, 3, 12, 12, 16, 4, None),
    (2, 3, 13, 12, 16, 5, [(13, 4, 1), (0, 13, 6)]),
    (3, 5, 9, 40, 48, 16, [(9, 1, 2, 9, 3)] * 3),
    (2, 9, 21, 33, 100, 8, [(21, 1, 2, 3, 20, 5, 21, 4, 9)] * 2),
]


@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,T,D,H,K,lengths", CHUNK_SHAPES)
def test_chunk_entry_kernel_matches_plain(cuda, L, B, T, D, H, K, lengths,
                                          stash):
    """K1's chunk-entry variant: y bit-identical to K1-stash's, the entry
    carries within the bf16 tolerance of the plain version."""
    from repro_torch.kernels import lstm_cell

    ws, x, lens = _stacked(cuda, L, B, T, D, H, lengths, seed=B * 7 + H)
    before = lstm_cell.chunk_launches
    got = lstm_cell.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                              stash=stash)
    torch.cuda.synchronize()
    assert lstm_cell.chunk_launches == before + 1
    want = lstm_cell.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                               stash=stash, plain=True)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert _norm_err(g_, w_) <= BF16_TOL
    y_stash, _, _ = lstm_cell.blstm_layer_train(*ws, x, lens, stash=stash)
    assert torch.equal(got[0], y_stash)


@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,T,D,H,K,lengths", CHUNK_SHAPES)
def test_chunked_bwd_kernel_matches_plain_and_k2(cuda, L, B, T, D, H, K,
                                                 lengths, stash):
    """K3 against its plain version (bf16 tolerance) and, with an f32
    stash, against K2 on the same input at 2e-5 normalised."""
    from repro_torch.kernels import lstm_cell

    ws, x, lens = _stacked(cuda, L, B, T, D, H, lengths, seed=B * 7 + H + 1)
    g = torch.Generator().manual_seed(H + K)
    dy = torch.randn(L, B, T, 2 * H, generator=g).to(cuda, torch.bfloat16)
    y, hb, cb = lstm_cell.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                                    stash=stash)
    args = (*ws, x, y, hb, cb, dy, lens)
    before = lstm_cell.chunked_bwd_launches
    dx, grads = lstm_cell.blstm_layer_bwd_chunked(*args, chunk=K)
    torch.cuda.synchronize()
    assert lstm_cell.chunked_bwd_launches == before + 1
    dx_w, grads_w = lstm_cell.blstm_layer_bwd_chunked(*args, chunk=K,
                                                      plain=True)
    assert dx.dtype == torch.bfloat16 and _norm_err(dx, dx_w) <= BF16_TOL
    for d in range(2):
        for g_, w_ in zip(grads[d], grads_w[d]):
            assert g_.dtype == torch.float32 and g_.shape == w_.shape
            assert _norm_err(g_, w_) <= BF16_TOL
    if lengths is not None:           # padded steps get no dx
        for l, row in enumerate(lengths):
            for b, n in enumerate(row):
                assert not dx[l, b, n:].any()
    _, no_dx = lstm_cell.blstm_layer_bwd_chunked(*args, chunk=K,
                                                 need_dx=False)
    for d in range(2):
        for a, b in zip(no_dx[d], grads[d]):
            assert torch.equal(a, b)
    if stash == "float32":
        _, acts, cseq = lstm_cell.blstm_layer_train(*ws, x, lens)
        dx2, grads2 = lstm_cell.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4],
                                                x, y, acts, cseq, dy, lens)
        # the replay reproduces K1-stash's gates, so dgates and dx agree
        # bit for bit; the weight sums differ in order only
        assert torch.equal(dx, dx2)
        for d in range(2):
            for g_, w_ in zip(grads[d], grads2[d]):
                assert _norm_err(g_, w_) <= 2e-5


@pytest.mark.parametrize("L,B,T,D,H,K,min_waves", [
    (16, 2, 300, 64, 512, 64, 2),   # 32 clusters of 16 CTAs, 2-row tiles
    (4, 3, 40, 32, 64, 16, 1),      # the reduced width, 4-row tiles
])
def test_resident_recurrences_in_waves_match_k1_stash_k2_and_plain(
        cuda, L, B, T, D, H, K, min_waves):
    """The resident forward recurrence at the full width's 16 learners x
    2 rows, T = 300, K = 64, which runs in two waves of clusters or more,
    and at the reduced width's 4 learners x 3 rows, with a length-1 row
    and rows whose last chunks are wholly
    masked: every output bit-identical to the streaming launch's,
    K1-chunk's y to K1-stash's, K3's dx to K2's, K3's gradients within
    2e-5 of K2's, both kernels within the bf16 tolerance of their plain
    versions.  Weights at 1/sqrt(fan-in), as the model draws them: at
    H = 512 the 0.3 of ``_stacked`` saturates every gate, and over 300
    steps the plain version's other sum order then drifts by more than
    any tolerance."""
    from unittest import mock

    from repro_torch.kernels import lstm_cell

    plan = lstm_cell.recur_plan(B, K, H)
    assert plan.path == "resident"
    assert lstm_cell.recur_waves(
        plan, L, B, lstm_cell.active_clusters(plan, H)) >= min_waves
    g = torch.Generator().manual_seed(21)

    def w(*shape, fan):
        return (torch.randn(*shape, generator=g) * fan ** -0.5).to(
            cuda, torch.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(L, D, 4 * H, fan=D), w(L, H, 4 * H, fan=H),
               (torch.randn(L, 4 * H, generator=g) * 0.1).to(cuda)]
    x = w(L, B, T, D, fan=1)
    lens = torch.randint(1, T + 1, (L, B), generator=g)
    lens[:, 0] = T
    lens[0, -1] = 1
    lens[-1, -1] = T - K - 7
    lens = lens.to(cuda, torch.int32)
    dy = torch.randn(L, B, T, 2 * H, generator=g).to(cuda, torch.bfloat16)

    def run():
        fwd = lstm_cell.blstm_layer_train_chunked(*ws, x, lens, chunk=K)
        y, acts, cseq = lstm_cell.blstm_layer_train(*ws, x, lens)
        k3 = lstm_cell.blstm_layer_bwd_chunked(*ws, x, *fwd, dy, lens,
                                               chunk=K)
        k2 = lstm_cell.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4], x, y,
                                       acts, cseq, dy, lens)
        return fwd, (y, acts, cseq), k3, k2

    def flat(out):
        if isinstance(out, (list, tuple)):
            return [t for o in out for t in flat(o)]
        return [] if out is None else [out]

    got = run()
    stream = lstm_cell.RecurPlan("stream", *lstm_cell._tile(B, H))
    with mock.patch.object(lstm_cell, "recur_plan", lambda *a: stream):
        want = run()
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    (fwd, (y, _, _), (dx, grads), (dx2, grads2)) = got
    assert torch.equal(fwd[0], y) and torch.equal(dx, dx2)
    plain = lstm_cell.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                                plain=True)
    for g_, w_ in zip(fwd, plain):
        assert _norm_err(g_, w_) <= BF16_TOL
    dx_w, grads_w = lstm_cell.blstm_layer_bwd_chunked(*ws, x, *fwd, dy, lens,
                                                      chunk=K, plain=True)
    assert _norm_err(dx, dx_w) <= BF16_TOL
    for d in range(2):
        for g_, w_, w2 in zip(grads[d], grads_w[d], grads2[d]):
            assert _norm_err(g_, w_) <= BF16_TOL
            assert _norm_err(g_, w2) <= 2e-5


def test_train_step_on_card_matches_plain(cuda):
    """Reduced-width ad_psgd step: the kernel path's loss and gradients
    against the plain path on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import setup_training
    from repro_torch.models.lstm import loss_train

    cfg = get_arch("swb2000-blstm").reduced()
    state, step, meta = setup_training(cfg, n_learners=3)
    batch = make_dataset(cfg, seq_len=9, batch=6, seed=0,
                         var_len=True).batch_at(0)
    lb = ST.split_learner_batch(
        {k: torch.as_tensor(v).to(cuda) for k, v in batch.items()}, 3)
    loss, grads = ST._value_and_grad(meta["loss_fn"], state["params"], lb)
    loss_w, grads_w = ST._value_and_grad(
        lambda p, b: loss_train(cfg, p, b, device=cuda, plain=True),
        state["params"], lb)
    assert torch.allclose(loss, loss_w, rtol=BF16_TOL)
    for g_, w_ in zip(ST._leaves(grads), ST._leaves(grads_w)):
        assert _norm_err(g_, w_) <= BF16_TOL
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])


def _state(cuda, B, K, V, U, frames, seed):
    from repro_torch.decode import beam as DB

    g = torch.Generator().manual_seed(seed)
    st = DB.init_state(B, K, U, cuda)
    for _ in range(frames):
        lp = torch.log_softmax(torch.randn(B, V, generator=g) * 3.0,
                               -1).to(cuda)
        sel, npb, npnb = DB.frame_step_scores(
            lp, st.p_b, st.p_nb, st.last, st.phash, st.lens, blank=0,
            max_len=U, semiring="max")
        st = DB.apply_selection(st, sel, npb, npnb, blank=0, vocab=V)
    lp = torch.log_softmax(torch.randn(B, V, generator=g) * 3.0, -1)
    return st, lp.to(cuda).contiguous()


@pytest.mark.parametrize("semiring", ["max", "sum"])
@pytest.mark.parametrize("topc", [0, 5])
@pytest.mark.parametrize("B,K,V,U,frames,blank", [
    (3, 4, 9, 6, 4, 0),        # small vocab: prefixes merge
    (2, 3, 17, 2, 5, 3),       # U cap reached, blank not 0
    (2, 4, 6, 6, 0, 0),        # fresh beams: one live prefix
    (1, 16, 300, 8, 3, 0),     # widest beam the kernel takes
])
def test_beam_step_kernel_matches_plain(cuda, semiring, topc, B, K, V, U,
                                        frames, blank):
    from repro_torch.decode import beam as DB
    from repro_torch.decode import kernel as DK

    st, lp = _state(cuda, B, K, V, U, frames, seed=K * V)
    for max_len in (U, 0):      # max_len 0: fewer live candidates than K
        args = (lp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
        kw = dict(blank=blank, max_len=max_len, semiring=semiring)
        before = DK.launches
        got = DK.beam_frame_step(*args, topc=topc, **kw)
        torch.cuda.synchronize()
        assert DK.launches == before + 1
        want = (DB.frame_step_scores_topc(*args, topc=topc, **kw) if topc
                else DB.frame_step_scores(*args, **kw))
        assert torch.equal(got[0], want[0]), (got[0], want[0])
        for g_, w_ in zip(got[1:], want[1:]):
            if semiring == "max":
                assert torch.equal(g_, w_)
            else:
                torch.testing.assert_close(g_, w_, rtol=SUM_TOL, atol=SUM_TOL)


@pytest.mark.parametrize("topc", [0, 16, 24])   # 24: the warps' rounds
@pytest.mark.parametrize("B,K,V,blank", [
    (4, 8, 32000, 0),          # serve's rows: 8 CTAs a row
    (3, 5, 4097, 2),           # V not a multiple of the slices
    (2, 16, 1500, 0),          # K = 16
])
def test_beam_step_slices_agree(cuda, monkeypatch, topc, B, K, V, blank):
    """Every slicing of a row (one CTA to eight, and the plan's) gives the
    plain step's sel and scores bit for bit, ties across slice bounds
    included; two calls give the same bits.  The slice count is driven
    through the SM count ``beam_slices`` reads."""
    from repro_torch.decode import beam as DB
    from repro_torch.decode import kernel as DK

    st, lp = _state(cuda, B, K, V, 64, 4, seed=V + K)
    lp[:, V // 2] = lp[:, V // 2 - 1]             # a tie across a bound
    lp[:, V - 1] = lp[:, 1]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert DK.beam_slices(B, V, n_sm) >= 2
    for max_len in (64, 0):
        args = (lp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
        kw = dict(blank=blank, max_len=max_len, semiring="max", topc=topc)
        want = (DB.frame_step_scores_topc(*args, **kw) if topc else
                DB.frame_step_scores(*args, **{k: v for k, v in kw.items()
                                               if k != "topc"}))
        DK.beam_frame_step(*args, **kw)           # binds the entry point
        seen = set()
        for slices in (0, 1, 2, 3, 8):
            monkeypatch.setattr(DK, "_beam_n_sm", B * slices or n_sm)
            seen.add(DK.beam_slices(B, V, DK._beam_n_sm))
            got = DK.beam_frame_step(*args, **kw)
            again = DK.beam_frame_step(*args, **kw)
            torch.cuda.synchronize()
            for g_, a_, w_ in zip(got, again, want):
                assert torch.equal(g_, w_) and torch.equal(a_, g_), slices
        assert {1, 2} <= seen


def test_serve_on_card_matches_cpu(cuda):
    """Reduced-width server: parked posteriors agree with the CPU's at
    the bf16 tolerance, and decoding the same peaked posteriors gives the
    CPU's hypotheses."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import AsrServer, asr_requests, serve_all

    cfg = get_arch("swb2000-blstm").reduced()
    pending = asr_requests(cfg, requests=3, seq_len=24)
    cpu = AsrServer(cfg, slots=3, max_frames=24, chunk=8, device="cpu")
    gpu = AsrServer(cfg, slots=3, max_frames=24, chunk=8)
    gpu.params = _to(cpu.params, cuda)
    for rid, f in pending:
        assert cpu.admit(rid, f) and gpu.admit(rid, f)
    scale = float(cpu.logits.abs().max())
    err = float((gpu.logits.cpu() - cpu.logits).abs().max()) / scale
    assert err <= BF16_TOL, err
    # random-init posteriors are near uniform; decode peaked ones so that
    # ulp-level log_softmax differences cannot reorder candidates
    g = torch.Generator().manual_seed(3)
    peaked = torch.randn(cpu.logits.shape, generator=g) * 3.0
    cpu.logits.copy_(peaked)
    gpu.logits.copy_(peaked.to(cuda))
    fin_cpu, _ = serve_all(cpu, [])
    fin_gpu, _ = serve_all(gpu, [])
    assert dict(fin_gpu) == dict(fin_cpu) and len(fin_cpu) == 3
    assert all(0 < t < cfg.vocab for _, h in fin_gpu for t in h)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# the LM slice: K7 / K8 decode attention and K6 argmax
# ---------------------------------------------------------------------------

def _attn_inputs(cuda, B, S, KV, M, E, seed, n_pages=None, P=None):
    g = torch.Generator().manual_seed(seed)
    cache = (n_pages, P) if n_pages else (B, S)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(cuda, torch.bfloat16)

    return (r(B, 1, KV * M, E), r(*cache, KV, E), r(*cache, KV, E),
            r(B, 1, KV, E), r(B, 1, KV, E))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("B,S,KV,M,E,block_s,window", [
    (2, 40, 2, 3, 64, 16, None),       # smollm's group, ragged last tile
    (3, 33, 5, 3, 64, 16, 7),          # a window, S not a tile multiple
    (1, 300, 1, 16, 128, 128, None),   # the widest group the kernel takes
    (2, 64, 4, 1, 32, 64, 5),          # M = 1, one tile
    (2, 70, 2, 5, 256, 32, None),      # E = 256
    (8, 1024, 5, 3, 64, None, None),   # the serve shape, default tile
])
def test_decode_attention_kernel_matches_plain(cuda, delta, B, S, KV, M, E,
                                               block_s, window):
    from repro_torch.kernels import decode_attention as DA

    q, kc, vc, kn, vn = _attn_inputs(cuda, B, S, KV, M, E, seed=S + M)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    tile = block_s or DA.DEFAULT_BLOCK_S
    for pos in sorted({0, tile - 1, tile, S // 2, S - 1}):
        before = DA.launches
        got = DA.decode_attention(q, kc, vc, pos, window=window,
                                  block_s=block_s, **kw)
        torch.cuda.synchronize()
        assert DA.launches == before + 1
        want = DA.decode_attention_ref(q, kc, vc, pos, window=window, **kw)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert _norm_err(got, want) <= BF16_TOL, (pos, _norm_err(got, want))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("M,E,P", [(3, 64, 16), (2, 32, 8), (4, 128, 32)])
def test_paged_kernel_matches_plain(cuda, delta, M, E, P):
    """A shuffled pool, table rows padded with arbitrary valid ids past
    each request's pages (never read), and one out-of-range pad id."""
    from repro_torch.kernels import decode_attention as DA

    B, KV, W, n_pages, used = 3, 2, 12, 64, 9
    q, kp, vp, kn, vn = _attn_inputs(cuda, B, None, KV, M, E, seed=P,
                                     n_pages=n_pages, P=P)
    g = torch.Generator().manual_seed(P)
    perm = torch.randperm(n_pages, generator=g)
    tbl = torch.randint(0, n_pages, (B, W), generator=g)
    tbl[:, :used] = perm[:B * used].reshape(B, used)
    tbl[0, -1] = n_pages + 5
    tbl = tbl.to(cuda, torch.int32)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    for pos in (0, P - 1, P, 5 * P + 3, used * P - 1):
        for window in (None, 2 * P + 1):
            before = DA.paged_launches
            got = DA.paged_decode_attention(q, kp, vp, tbl, pos,
                                            window=window, **kw)
            torch.cuda.synchronize()
            assert DA.paged_launches == before + 1
            want = DA.paged_decode_attention_ref(q, kp, vp, tbl, pos,
                                                 window=window, **kw)
            assert _norm_err(got, want) <= BF16_TOL, (pos, window)


@pytest.mark.parametrize("delta", [False, True])
def test_paged_kernel_equals_dense_kernel_at_page_tile(cuda, delta):
    """Contiguous pages through the paged kernel equal the dense kernel at
    block_s = P, bit for bit (one tile walk)."""
    from repro_torch.kernels import decode_attention as DA

    B, KV, M, E, P, W = 4, 5, 3, 64, 16, 8
    q, kc, vc, kn, vn = _attn_inputs(cuda, B, W * P, KV, M, E, seed=17)
    kp = kc.reshape(B * W, P, KV, E)
    vp = vc.reshape(B * W, P, KV, E)
    tbl = torch.arange(B * W, device=cuda, dtype=torch.int32).reshape(B, W)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    for pos in (0, 15, 16, 77, W * P - 1):
        for window in (None, 20):
            dense = DA.decode_attention(q, kc, vc, pos, window=window,
                                        block_s=P, **kw)
            paged = DA.paged_decode_attention(q, kp, vp, tbl, pos,
                                              window=window, **kw)
            assert torch.equal(dense, paged), (pos, window)


@pytest.mark.parametrize("delta", [False, True])
def test_decode_attention_kernel_one_request_long_window(cuda, delta):
    """hymba-1.5b's decode shape at one request: a 2048-row cache, 25
    heads over 5, a 1024-row window; the walk starts at the window and
    its rows are split over a cluster of 16 CTAs."""
    from repro_torch.kernels import decode_attention as DA

    B, S, KV, M, E, W = 1, 2048, 5, 5, 64, 1024
    q, kc, vc, kn, vn = _attn_inputs(cuda, B, S, KV, M, E, seed=41)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    for pos in (0, 31, W - 1, W, 1600, S - 1):
        before = DA.launches
        got = DA.decode_attention(q, kc, vc, pos, window=W, **kw)
        torch.cuda.synchronize()
        assert DA.launches == before + 1
        want = DA.decode_attention_ref(q, kc, vc, pos, window=W, **kw)
        assert _norm_err(got, want) <= BF16_TOL, (pos, _norm_err(got, want))
    plan = DA.decode_plan(B, KV, S, E, 1600, W, delta, DA.DEFAULT_BLOCK_S,
                          DA.fit_splits(delta, M, E, B * KV))
    assert plan.lo == 577 and plan.n_split >= 13     # <= 5 tiles each


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("P", [16, 5])
def test_paged_kernel_splits_span_pages(cuda, delta, P):
    """Two rows over a shuffled pool: each split gathers several pages
    (every edge on a page edge) in three rounds through two buffers; table
    entries past the rows' pages are out of range (-1, n_pages + 7) and
    never read."""
    from repro_torch.kernels import decode_attention as DA

    B, KV, M, E = 2, 2, 3, 64
    used = 9000 // P + 1
    W, n_pages = used + 4, B * used + 16
    q, kp, vp, kn, vn = _attn_inputs(cuda, B, None, KV, M, E, seed=P + 3,
                                     n_pages=n_pages, P=P)
    g = torch.Generator().manual_seed(P)
    perm = torch.randperm(n_pages, generator=g)
    tbl = torch.full((B, W), n_pages + 7)
    tbl[:, :used] = perm[:B * used].reshape(B, used)
    tbl[1, used:] = -1
    tbl = tbl.to(cuda, torch.int32)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    n_fit = DA.fit_splits(delta, M, E, B * KV)
    for pos, window in ((8999, None), (4500, None), (8999, 333),
                        (37, None)):
        plan = DA.decode_plan(B, KV, W * P, E, pos, window, delta, P, n_fit)
        if pos == 8999 and window is None:
            # several pages a split, more than two of the kernel's rounds
            # (16 KB of K rows: 128 at E = 64)
            assert plan.n_split > 1 and plan.rows > 2 * (8192 // E)
        got = DA.paged_decode_attention(q, kp, vp, tbl, pos, window=window,
                                        **kw)
        torch.cuda.synchronize()
        want = DA.paged_decode_attention_ref(q, kp, vp, tbl, pos,
                                             window=window, **kw)
        assert _norm_err(got, want) <= BF16_TOL, (pos, window)


@pytest.mark.parametrize("delta", [False, True])
def test_decode_attention_kernel_widest_group_many_splits(cuda, delta):
    """M = 16, E = 256 (the widest group and head the kernel takes) over
    one KV head: as many splits as the card fits (the partials' slots in
    rank 0 bound them), each in rounds of 32 rows through two buffers."""
    from repro_torch.kernels import decode_attention as DA

    B, S, KV, M, E = 1, 4096, 1, 16, 256
    q, kc, vc, kn, vn = _attn_inputs(cuda, B, S, KV, M, E, seed=256)
    kw = dict(k_new=kn, v_new=vn) if delta else {}
    for pos, window in ((S - 1, None), (2500, None), (3000, 1500)):
        got = DA.decode_attention(q, kc, vc, pos, window=window, **kw)
        torch.cuda.synchronize()
        want = DA.decode_attention_ref(q, kc, vc, pos, window=window, **kw)
        assert _norm_err(got, want) <= BF16_TOL, (pos, window)
    plan = DA.decode_plan(B, KV, S, E, S - 1, None, delta,
                          DA.DEFAULT_BLOCK_S,
                          DA.fit_splits(delta, M, E, B * KV))
    assert plan.n_split > 1 and plan.rows > 2 * (8192 // E)   # 32-row rounds


def test_decode_attention_kernels_deterministic(cuda):
    """Two calls of K7 and of K8 give the same bits (a fixed merge order,
    no atomics)."""
    from repro_torch.kernels import decode_attention as DA

    B, S, KV, M, E, P = 1, 1024, 5, 3, 64, 16
    q, kc, vc, kn, vn = _attn_inputs(cuda, B, S, KV, M, E, seed=5)
    kp = kc.reshape(B * S // P, P, KV, E)
    vp = vc.reshape(B * S // P, P, KV, E)
    tbl = torch.arange(B * S // P, device=cuda,
                       dtype=torch.int32).reshape(B, S // P)
    for pos in (511, S - 1):
        for kw in ({}, dict(k_new=kn, v_new=vn)):
            a = DA.decode_attention(q, kc, vc, pos, **kw)
            b = DA.decode_attention(q, kc, vc, pos, **kw)
            c = DA.paged_decode_attention(q, kp, vp, tbl, pos, **kw)
            d = DA.paged_decode_attention(q, kp, vp, tbl, pos, **kw)
            assert torch.equal(a, b) and torch.equal(c, d)
            assert torch.equal(a, c)          # block_s = P by default


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("V", [61, 512, 4099, 49152])
def test_argmax_kernel_matches_plain_bit_for_bit(cuda, dtype, V):
    from repro_torch.decode import kernel as DK

    g = torch.Generator().manual_seed(V)
    x = torch.randn(9, V, generator=g)
    x[1, [5, 17, V - 1]] = 9.0                  # a three-way tie
    x[2, [3, V // 2]] = float("nan")            # the first NaN wins
    x[2, 10] = float("inf")
    x[3] = float("-inf")
    x[4] = 0.0
    x[4, [7, 8]] = -0.0
    x[5, V - 1] = float("inf")
    x[6] = torch.round(x[6] * 4) / 4            # many ties in bf16
    x[7, 0] = float("nan")
    x = x.to(cuda, dtype)
    for rows in (x, x[1:8].contiguous()):       # also an unaligned row base
        before = DK.argmax_launches
        got = DK.argmax_tokens(rows)
        torch.cuda.synchronize()
        assert DK.argmax_launches == before + 1
        assert torch.equal(got, DK.argmax_ref(rows)), (got, DK.argmax_ref(rows))


def _argmax_pattern(x, S, pattern, g):
    """Fill x (B, V) on the card with rows that only the right slicing and
    merge get right: equal maxima on both sides of every slice bound
    ("ties"), an inf in the first slice and NaN only in the last ("nan"),
    all -inf ("-inf"); each row's bounds from its own address."""
    from repro_torch.decode import kernel as DK

    B, V = x.shape
    size = x.element_size()
    rows = torch.randn(B, V, generator=g)
    for b in range(B):
        head = (16 - x[b].data_ptr() % 16) % 16 // size
        bounds = DK.argmax_bounds(V, S, size, head)
        if pattern == "ties":
            for lo, hi in bounds:
                if lo < hi:
                    rows[b, lo] = rows[b, hi - 1] = 7.0
        elif pattern == "nan":
            rows[b, 0] = float("inf")
            lo, hi = bounds[-1]
            rows[b, lo:hi:5] = float("nan")
        elif pattern == "-inf":
            rows[b] = float("-inf")
    x.copy_(rows)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,V", [(1, 7), (8, 49152), (8, 49153),
                                 (4, 151936)])
def test_argmax_slices_match_plain_bit_for_bit(cuda, B, V, dtype, offset):
    """K6's rows split over clusters of up to 8 CTAs, at the serving
    vocabularies and odd ones, aligned and at an offset of one element."""
    from repro_torch.decode import kernel as DK

    DK._argmax_entry()
    S = DK.argmax_slices(B, V, torch.empty(0, dtype=dtype).element_size(),
                         DK._n_sm)
    g = torch.Generator().manual_seed(B * V + offset)
    base = torch.empty(B * V + offset, dtype=dtype, device=cuda)
    x = base[offset:].view(B, V)
    for pattern in ("ties", "nan", "-inf", "random"):
        _argmax_pattern(x, S, pattern, g)
        before = DK.argmax_launches
        got = DK.argmax_tokens(x)
        torch.cuda.synchronize()
        assert DK.argmax_launches == before + 1
        want = DK.argmax_ref(x)
        assert torch.equal(got, want), (pattern, S, got, want)


def test_lm_servers_on_card_match_cpu(cuda):
    """Reduced smollm-360m: the card's first-token logits agree with the
    CPU's at bf16 tolerance, and both servers finish every request through
    the three kernels."""
    from repro_torch.configs import get_arch
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.launch.serve import (PagedServer, Server, lm_requests,
                                          serve_lm)

    cfg = get_arch("smollm-360m").reduced()
    pending = lm_requests(cfg, [5, 9, 5, 12])
    cpu = Server(cfg, slots=2, max_len=32, device="cpu")
    gpu = Server(cfg, slots=2, max_len=32)
    gpu.params = _to(cpu.params, cuda)
    want, _ = cpu.model.prefill_fn(cpu.params, {"tokens": torch.as_tensor(
        pending[1][1][None])}, cache_len=32)
    got, _ = gpu.model.prefill_fn(gpu.params, {"tokens": torch.as_tensor(
        pending[1][1][None]).to(cuda)}, cache_len=32)
    assert _norm_err(got.cpu(), want) <= BF16_TOL
    counts = (DA.launches, DA.paged_launches, DK.argmax_launches)
    fin, _, _, _ = serve_lm(gpu, pending, 6)
    paged = PagedServer(cfg, pool_pages=16, page_size=4, max_len=32)
    paged.params = gpu.params
    fin_p, _, _, _ = serve_lm(paged, pending, 6)
    assert sorted(dict(fin)) == sorted(dict(fin_p)) == [0, 1, 2, 3]
    assert all(len(t) == 6 and all(0 <= x < cfg.vocab for x in t)
               for t in list(dict(fin).values()) + list(dict(fin_p).values()))
    now = (DA.launches, DA.paged_launches, DK.argmax_launches)
    assert all(n > c for n, c in zip(now, counts))


def _ssd_inputs(cuda, B, S, H, P, G, N, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g).to(cuda, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g)).to(cuda)
    A = (-torch.exp(0.5 * torch.randn(H, generator=g))).to(cuda)
    Bm = torch.randn(B, S, G, N, generator=g).to(cuda, dtype)
    Cm = torch.randn(B, S, G, N, generator=g).to(cuda, dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 40, 3, 16, 3, 8, 16),         # ragged last chunk
    (2, 7, 2, 16, 2, 16, 16),         # S < Q
    (3, 100, 4, 24, 2, 12, 32),       # G < H, P not a multiple of 16
    (2, 129, 8, 64, 1, 128, 64),      # one group, the full state width
    (1, 300, 2, 32, 1, 128, 256),     # the full chunk, ragged
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, H, P, G, N, chunk):
    """K9 against ``ssd_plain`` on the same inputs: both compute in f32, so
    y agrees within one rounding of its type (2e-2 normalised for bf16,
    1e-5 for f32) and the f32 state within 1e-4 normalised (sums in
    another order)."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_plain

    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, G, N, seed=S + N,
                                   dtype=dtype)
    before = ssd_scan.launches
    y, h = ssd_scan.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_h = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    assert _norm_err(y, want_y) <= tol
    assert _norm_err(h, want_h) <= 1e-4


def test_ssd_kernel_at_full_width_prefill(cuda):
    """mamba2-370m's prefill shape: B = 1, H 32, P 64, N 128, one group,
    Q 256, a 700-token prompt (the last chunk ragged)."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_plain

    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 700, 32, 64, 1, 128, seed=1)
    y, h = ssd_scan.ssd(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    want_y, want_h = ssd_plain(x, dt, A, Bm, Cm, chunk=256)
    assert _norm_err(y, want_y) <= BF16_TOL
    assert _norm_err(h, want_h) <= 1e-4


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 200, 32, 64, 128),     # few items: the plan splits P
    (1, 700, 32, 64, 128),     # mamba2-370m: one wave of 64-channel CTAs
    (1, 1500, 50, 64, 16),     # hymba-1.5b: three waves
])
def test_ssd_plan_regimes_on_card(cuda, B, S, H, P, N):
    """Both slices of P the plan picks from (32 channels an output CTA
    where the items fill at most half the card, else 64) hold y and the
    state against ``ssd_plain``; two calls give the same bits (no
    atomics, a fixed order)."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_plain

    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, 1, N, seed=S)
    want_y, want_h = ssd_plain(x, dt, A, Bm, Cm, chunk=256)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ssd_scan.ssd_plan(B, S, H, P, 1, N, min(256, S), n_sm)
    assert plan["p_tile"] == (32 if 2 * plan["items"] <= n_sm else 64)
    y, h = ssd_scan.ssd(x, dt, A, Bm, Cm, chunk=256)
    y2, h2 = ssd_scan.ssd(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert _norm_err(y, want_y) <= BF16_TOL
    assert _norm_err(h, want_h) <= 1e-4


def test_ssm_server_on_card_matches_cpu(cuda):
    """Reduced mamba2-370m: the card's prefill logits agree with the CPU's
    at bf16 tolerance for a ragged prompt, and the server finishes every
    request with K9 launched once per layer per admission."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.serve import Server, lm_requests, serve_lm

    cfg = get_arch("mamba2-370m").reduced()
    pending = lm_requests(cfg, [5, 20, 2, 33])
    cpu = Server(cfg, slots=2, max_len=64, device="cpu")
    gpu = Server(cfg, slots=2, max_len=64)
    gpu.params = _to(cpu.params, cuda)
    tokens = torch.as_tensor(pending[1][1][None])
    want, _ = cpu.model.prefill_fn(cpu.params, {"tokens": tokens})
    got, _ = gpu.model.prefill_fn(gpu.params, {"tokens": tokens.to(cuda)})
    assert _norm_err(got.cpu(), want) <= BF16_TOL
    before = ssd_scan.launches
    fin, _, _, _ = serve_lm(gpu, pending, 6)
    assert sorted(dict(fin)) == [0, 1, 2, 3]
    assert ssd_scan.launches - before == cfg.n_layers * len(pending)


# ---------------------------------------------------------------------------
# the hybrid slice: K11 flash attention, the hybrid server
# ---------------------------------------------------------------------------

def _flash_inputs(cuda, B, Sq, Sk, H, KV, E, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g).to(cuda, torch.bfloat16)
            for s in ((B, Sq, H, E), (B, Sk, KV, E), (B, Sk, KV, E))]


def _check_flash(cuda, B, Sq, Sk, H, KV, E, causal, window, q_offset, seed):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_plain

    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, KV, E, seed)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = FA.launches
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    # each (position, head) row over its own largest value: a tensor-wide
    # scale is set by rows that see one key and would hide a row of a
    # thousand keys that is off by one of them
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1) + 1e-6
    assert float((err / scale).max()) <= BF16_TOL


@pytest.mark.parametrize("B,Sq,Sk,H,KV,E,causal,window,q_offset", [
    (1, 1, 1, 4, 2, 64, True, 0, 0),           # one query
    (2, 37, 37, 6, 2, 64, True, 0, 0),         # ragged Sq, M = 3
    (1, 100, 100, 10, 2, 64, True, 16, 0),     # windowed, M = 5
    (1, 130, 500, 25, 5, 64, True, 64, 370),   # q_offset, Sk > Sq
    (1, 50, 90, 4, 1, 64, True, 0, 40),        # q_offset, global
    (2, 90, 70, 8, 2, 64, False, 0, 0),        # non-causal, Sk < Sq
    (1, 200, 200, 8, 1, 128, True, 64, 0),     # M = 8, E = 128
    (1, 65, 65, 3, 3, 32, True, 0, 0),         # MHA, E = 32
    (1, 300, 300, 25, 5, 64, True, 2 ** 30, 0),  # GLOBAL_WINDOW
    # Sq * M one below, at and one above a multiple of 128 rows
    (1, 85, 85, 6, 2, 64, True, 0, 0),         # M = 3: 255 rows
    (1, 128, 128, 6, 2, 64, True, 0, 0),       # M = 3: 384
    (1, 43, 43, 6, 2, 64, True, 0, 0),         # M = 3: 129
    (1, 51, 51, 10, 2, 64, True, 0, 0),        # M = 5: 255
    (1, 128, 128, 10, 2, 64, True, 0, 0),      # M = 5: 640
    (1, 77, 77, 10, 2, 64, True, 0, 0),        # M = 5: 385
    # a window edge on a 64-key tile boundary, and one key past it
    (1, 300, 300, 10, 2, 64, True, 64, 0),
    (1, 300, 300, 10, 2, 64, True, 65, 0),
    # Sk a multiple of the key tile, and one past it (TMA zero-fill, mask)
    (1, 100, 128, 6, 2, 64, False, 0, 0),
    (1, 100, 129, 6, 2, 64, False, 0, 0),
    # B = 2, Sk no multiple of the tile: batch 1's keys stay out of 0's
    (2, 70, 70, 6, 2, 64, True, 0, 0),
    (2, 50, 100, 6, 2, 64, False, 0, 0),
    (1, 64, 300, 15, 5, 64, True, 0, 236),     # q_offset, Sk > Sq
    # 192-row items (the plan's choice here): Sq * M one below, at and one
    # above a multiple of 192 at M = 5, at one at M = 3 with B = 2
    (1, 1459, 1459, 25, 5, 64, True, 0, 0),
    (1, 1536, 1536, 25, 5, 64, True, 1024, 0),
    (1, 1421, 1421, 25, 5, 64, True, 0, 0),
    (2, 1024, 1024, 24, 8, 64, True, 0, 0),
    # the plan's 64-row items (two warpgroups share the key walk): 8 heads
    # over one KV head at S = 1500 and smollm's S = 600; granite's S = 700
    # takes 128 rows
    (1, 1500, 1500, 8, 1, 64, True, 0, 0),
    (1, 600, 600, 15, 5, 64, True, 0, 0),
    (1, 700, 700, 24, 8, 64, True, 0, 0),
    (2, 100, 130, 6, 2, 32, True, 0, 0),       # E = 32
    (2, 100, 130, 6, 2, 128, True, 0, 0),      # E = 128
    (1, 300, 300, 6, 3, 128, False, 0, 0),     # E = 128, non-causal
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, E,
                                              causal, window, q_offset):
    """K11 against ``flash_attention_plain`` (all f32; the kernel rounds
    p to bf16 once before p.v, as the reference model's prefill does):
    within one bf16 rounding of the output."""
    _check_flash(cuda, B, Sq, Sk, H, KV, E, causal, window, q_offset,
                 seed=Sq + H)


@pytest.mark.parametrize("Sq,H,window", [
    (1500, 25, 1024),         # hymba-1.5b, a windowed layer
    (1500, 25, 2 ** 30),      # hymba-1.5b, a global layer
    (600, 15, 2 ** 30),       # smollm-360m
])
def test_flash_attention_kernel_at_serving_shapes(cuda, Sq, H, window):
    _check_flash(cuda, 1, Sq, Sq, H, 5, 64, True, window, 0, seed=1)


@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("M", [3, 5])
def test_flash_attention_kernel_every_item_size(cuda, monkeypatch, rows, M):
    """Each item size of the launch plan, forced, with Sq * M one below,
    at and one above a multiple of it (where M allows), causal, windowed
    on a key-tile edge and non-causal with Sk past a tile, B = 2."""
    from repro_torch.kernels import flash_attention as FA

    def forced(B, Sq, KV, M, *rest):
        tiles = -(-Sq * M // rows)
        return FA.Plan(rows, tiles, tiles * B * KV)
    monkeypatch.setattr(FA, "plan", forced)
    for d in (-1, 0, 1):
        ks = [k for k in range(2, 12) if (rows * k + d) % M == 0]
        if not ks:
            continue
        Sq = (rows * ks[0] + d) // M
        for causal, window, Sk in ((True, 0, Sq), (True, 64, Sq),
                                   (False, 0, Sq + 65)):
            _check_flash(cuda, 2, Sq, Sk, 2 * M, 2, 64, causal, window, 0,
                         seed=Sq + rows)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(cuda, 1, 16, 16, 4, 2, 64, seed=2)
    with pytest.raises(ValueError, match="bf16"):
        FA.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    q48, k48, v48 = _flash_inputs(cuda, 1, 16, 16, 4, 2, 48, seed=3)
    with pytest.raises(ValueError, match="head_dim 48"):
        FA.flash_attention(q48, k48, v48)


def test_hybrid_server_on_card_matches_cpu(cuda):
    """Reduced hymba-1.5b: the card's prefill logits agree with the CPU's
    at bf16 tolerance for a prompt past the window, and the server
    finishes every request with K11 and K9 launched once per layer per
    admission."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.serve import Server, lm_requests, serve_lm

    cfg = get_arch("hymba-1.5b").reduced()
    pending = lm_requests(cfg, [5, 100, 2, 70])
    cpu = Server(cfg, slots=2, max_len=128, device="cpu")
    gpu = Server(cfg, slots=2, max_len=128)
    gpu.params = _to(cpu.params, cuda)
    tokens = torch.as_tensor(pending[1][1][None])
    want, _ = cpu.model.prefill_fn(cpu.params, {"tokens": tokens})
    got, _ = gpu.model.prefill_fn(gpu.params, {"tokens": tokens.to(cuda)})
    assert _norm_err(got.cpu(), want) <= BF16_TOL
    before = (FA.launches, ssd_scan.launches)
    fin, _, _, _ = serve_lm(gpu, pending, 6)
    assert sorted(dict(fin)) == [0, 1, 2, 3]
    n = cfg.n_layers * len(pending)
    assert (FA.launches - before[0], ssd_scan.launches - before[1]) == (n, n)


def test_lm_servers_on_card_admit_a_600_token_prompt(cuda):
    """Reduced smollm-360m at max_len 1024: both servers admit a
    600-token prompt (K11 takes any length) and decode it."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (PagedServer, Server, lm_requests,
                                          serve_lm)

    cfg = get_arch("smollm-360m").reduced()
    pending = lm_requests(cfg, [600, 37])
    dense = Server(cfg, slots=2, max_len=1024)
    paged = PagedServer(cfg, pool_pages=128, page_size=16, max_len=1024)
    paged.params = dense.params
    for server in (dense, paged):
        fin, _, _, _ = serve_lm(server, pending, 4)
        assert sorted(dict(fin)) == [0, 1]
        assert all(len(t) == 4 for t in dict(fin).values())


# ---------------------------------------------------------------------------
# the moe slice: K10 fused dense MoE, the moe servers
# ---------------------------------------------------------------------------

def _moe_inputs(cuda, T, d, E, f, k, mode, seed):
    """x, the (T, E) router weights (renormalised top-k; "all": the whole
    softmax; "skip": expert 1 never selected; "last8": top-k of the last
    8 experts only; "zero_row": token T // 2 with no weight) and wi/wg/wo
    at the model's init scales, on the card."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g).to(cuda, torch.bfloat16)
    wi = (torch.randn(E, d, f, generator=g) / d ** 0.5).to(cuda,
                                                           torch.bfloat16)
    wg = (torch.randn(E, d, f, generator=g) / d ** 0.5).to(cuda,
                                                           torch.bfloat16)
    wo = (torch.randn(E, f, d, generator=g) / f ** 0.5).to(cuda,
                                                           torch.bfloat16)
    logits = torch.randn(T, E, generator=g)
    if mode == "skip":
        logits[:, 1] = -float("inf")
    if mode == "last8":
        logits[:, :E - 8] = -float("inf")
    w = torch.softmax(logits, -1)
    if mode != "all":
        top, idx = torch.topk(w, k, -1)
        w = torch.zeros_like(w).scatter_(-1, idx,
                                         top / top.sum(-1, keepdim=True))
    if mode == "zero_row":
        w[T // 2] = 0.0
    return x, w.to(cuda), wi, wg, wo


def _row_normalised(got, want):
    """Each token row's max error over its own largest value."""
    err = (got.float() - want.float()).abs().amax(-1)
    return float((err / (want.float().abs().amax(-1) + 1e-6)).max())


@pytest.mark.parametrize("T,d,E,f,k,act,mode", [
    (1, 1536, 40, 512, 8, "swiglu", "topk"),     # granite, one token
    (8, 1536, 40, 512, 8, "swiglu", "topk"),     # a full decode wave
    (700, 1536, 40, 512, 8, "swiglu", "topk"),   # ragged against 64 rows
    (37, 256, 4, 128, 2, "gelu", "topk"),        # reduced granite, gelu
    (64, 1536, 40, 512, 8, "swiglu", "all"),     # every weight non-zero
    (300, 1536, 40, 512, 8, "swiglu", "skip"),   # one expert never used
    (20, 512, 5, 256, 2, "swiglu", "topk"),      # 4 CTAs a cluster
    (37, 1536, 40, 512, 8, "swiglu", "zero_row"),  # a token with no weight
    (1, 1536, 40, 512, 8, "swiglu", "last8"),    # experts 32-39 only
    (16, 1536, 40, 512, 8, "swiglu", "topk"),    # the last decode T
    (17, 1536, 40, 512, 8, "swiglu", "topk"),    # the first prefill T
])
def test_moe_dense_kernel_matches_plain(cuda, T, d, E, f, k, act, mode):
    """K10 against ``moe_dense_plain`` (whose products round to bf16 as
    the reference oracle's do): within one bf16 rounding of each token
    row's largest value; every value finite."""
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels.ref import moe_dense_plain

    x, w, wi, wg, wo = _moe_inputs(cuda, T, d, E, f, k, mode, seed=T + E)
    before = MD.launches
    got = MD.moe_dense(x, w, wi, wg, wo, act=act)
    torch.cuda.synchronize()
    assert MD.launches == before + 1
    want = moe_dense_plain(x, w, wi, wg, wo, act=act)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert bool(torch.isfinite(got).all())
    assert _row_normalised(got, want) <= BF16_TOL


def test_moe_dense_rows_do_not_depend_on_T(cuda):
    """Each token's output is bit-identical whatever T is and whichever
    tokens share its tile: rows of a T = 700 call (64-row tiles) launched
    alone (16-row tiles) and in a T = 9 call."""
    from repro_torch.kernels import moe_dense as MD

    x, w, wi, wg, wo = _moe_inputs(cuda, 700, 1536, 40, 512, 8, "topk", 5)
    full = MD.moe_dense(x, w, wi, wg, wo)
    for r in (0, 15, 16, 64, 345, 699):
        assert torch.equal(MD.moe_dense(x[r:r + 1], w[r:r + 1], wi, wg, wo),
                           full[r:r + 1]), r
    assert torch.equal(MD.moe_dense(x[100:109], w[100:109], wi, wg, wo),
                       full[100:109])


@pytest.mark.parametrize("T,mode", [(1, "topk"), (8, "topk"),
                                    (700, "topk"), (37, "zero_row"),
                                    (1, "last8"), (64, "all")])
def test_moe_dense_work_list_and_determinism(cuda, T, mode):
    """The work list the kernel's first launch builds on the card equals
    ``work_list``'s; two calls are bit-identical; a token with no weight
    gets an exact 0 row."""
    from repro_torch.kernels import moe_dense as MD

    x, w, wi, wg, wo = _moe_inputs(cuda, T, 1536, 40, 512, 8, mode, T + 3)
    got, want = MD.device_work_list(w, 1536), MD.work_list(w.cpu())
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    y1 = MD.moe_dense(x, w, wi, wg, wo)
    y2 = MD.moe_dense(x, w, wi, wg, wo)
    assert torch.equal(y1, y2)
    if mode == "zero_row":
        assert torch.equal(y1[T // 2], torch.zeros_like(y1[T // 2]))


def test_moe_dense_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import moe_dense as MD

    x, w, wi, wg, wo = _moe_inputs(cuda, 8, 256, 4, 128, 2, "topk", 6)
    with pytest.raises(ValueError, match="x: expected"):
        MD.moe_dense(x.float(), w, wi, wg, wo)
    with pytest.raises(ValueError, match="router_w: expected"):
        MD.moe_dense(x, w.to(torch.bfloat16), wi, wg, wo)
    with pytest.raises(ValueError, match="contiguous"):
        MD.moe_dense(x, w, wi.transpose(1, 2).contiguous().transpose(1, 2),
                     wg, wo)
    x2, w2, wi2, wg2, wo2 = _moe_inputs(cuda, 8, 256, 4, 96, 2, "topk", 7)
    with pytest.raises(ValueError, match="d_ff 96"):
        MD.moe_dense(x2, w2, wi2, wg2, wo2)
    x3, w3, wi3, wg3, wo3 = _moe_inputs(cuda, 8, 320, 4, 128, 2, "topk", 8)
    with pytest.raises(ValueError, match="d_model 320"):
        MD.moe_dense(x3, w3, wi3, wg3, wo3)


def test_moe_servers_on_card_match_cpu(cuda):
    """Reduced granite-moe-3b-a800m: the card's prefill logits agree with
    the CPU's at bf16 tolerance, and both servers finish every request
    with K10 launched once per layer of every admission and every decode
    call."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.launch.serve import (PagedServer, Server, lm_requests,
                                          serve_lm)

    cfg = get_arch("granite-moe-3b-a800m").reduced()
    pending = lm_requests(cfg, [5, 70, 2, 33], shared_prefix=2)
    cpu = Server(cfg, slots=2, max_len=128, device="cpu")
    gpu = Server(cfg, slots=2, max_len=128)
    gpu.params = _to(cpu.params, cuda)
    tokens = torch.as_tensor(pending[1][1][None])
    want, _ = cpu.model.prefill_fn(cpu.params, {"tokens": tokens})
    got, _ = gpu.model.prefill_fn(gpu.params, {"tokens": tokens.to(cuda)})
    assert _norm_err(got.cpu(), want) <= BF16_TOL
    paged = PagedServer(cfg, pool_pages=64, page_size=4, max_len=128)
    paged.params = gpu.params
    for server in (gpu, paged):
        before = MD.launches
        fin, admit_s, wave_s, _ = serve_lm(server, pending, 6)
        assert sorted(dict(fin)) == [0, 1, 2, 3]
        assert all(len(t) == 6 for t in dict(fin).values())
        calls = MD.launches - before - cfg.n_layers * len(pending)
        assert calls > 0 and calls % cfg.n_layers == 0


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("topology", ["ring", "uniform", "exp",
                                      "hierarchical"])
def test_elastic_mixer_on_card_matches_cpu(cuda, topology, wire):
    """The elastic mixer on the card against the same mixer on a CPU copy:
    the matrix is the host's on both, the codecs elementwise, the product
    in full f32 (1e-6 normalised)."""
    import numpy as np

    from repro_torch.core.transport import Transport

    L = 16
    t = Transport(topology=topology, wire=wire, pod_size=4,
                  staleness_lambda=0.2, bucket_bytes=4096)
    mix = t.make_elastic_mixer(L)
    rng = np.random.default_rng(3)
    g = torch.Generator().manual_seed(1)
    p = {"w": (torch.randn(L, 40, 33, generator=g) * 0.1).to(torch.bfloat16),
         "b": torch.randn(L, 700, generator=g)}
    for step in range(3):
        active = (rng.random(L) > 0.25).astype(np.float32)
        active[step] = 1.0
        stale = rng.integers(0, 4, L).astype(np.int32)
        up = np.triu(rng.random((L, L)) > 0.2, 1)
        edge = (up + up.T).astype(np.float32)
        np.fill_diagonal(edge, 1.0)
        corrupt = np.zeros(L, np.float32)
        want = mix(p, step, active, stale, edge, corrupt)
        got = mix({k: v.to(cuda) for k, v in p.items()}, step, active, stale,
                  edge, corrupt)
        for k in p:
            w_, g_ = want[k].float(), got[k].cpu().float()
            tol = 1e-6 if p[k].dtype == torch.float32 else 2.0 ** -7
            err = float((g_ - w_).abs().max()) / float(w_.abs().max())
            assert err <= tol, (step, k, err)
            for i in np.where(active == 0)[0]:
                assert torch.equal(got[k][i].cpu(), p[k][i]), (step, k, i)


def test_elastic_step_kernels_match_plain_and_freeze_the_dead(cuda):
    """Elastic steps at reduced width with K1-stash/K2 (once per layer a
    step) against the plain path from the same state (loss and params at
    2e-2), a dead learner frozen bit for bit on the card across its crash
    window, and the staleness counters kept on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.core.faults import Departure, FaultPlan, Straggler
    from repro_torch.data import make_dataset
    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.launch.train import setup_training
    from repro_torch.models import lstm as LS
    from repro_torch.optim.optimizers import sgd

    cfg = get_arch("swb2000-blstm").reduced()
    state, _, meta = setup_training(cfg, strategy_name="ad_psgd",
                                    n_learners=4, device=cuda, seed=3,
                                    elastic=True)

    def make(plain):
        return ST.make_elastic_train_step(
            meta["strategy"],
            lambda p, b: LS.loss_train(cfg, p, b, device=cuda, plain=plain),
            sgd(), lambda k: 0.05, n_learners=4,
            transport=meta["transport"])

    kern, plain = make(False), make(True)
    plan = FaultPlan(4, stragglers=(Straggler(0, 2),),
                     departures=(Departure(2, 1, 4),))
    ds = make_dataset(cfg, seq_len=8, batch=8, seed=0, var_len=True)
    frozen = None
    for k in range(5):
        faults = plan.step_inputs(k)
        ref, m_ref = plain(state, ds.batch_at(k), faults)
        before = LC.stash_launches, LC.bwd_launches
        state, m = kern(state, ds.batch_at(k), faults)
        torch.cuda.synchronize()
        assert LC.stash_launches - before[0] == cfg.n_layers
        assert LC.bwd_launches - before[1] == cfg.n_layers
        want = float(m_ref["loss"])
        assert abs(float(m["loss"]) - want) <= BF16_TOL * abs(want)
        for g_, w_ in zip(ST._leaves(state["params"]),
                          ST._leaves(ref["params"])):
            err = float((g_.float() - w_.float()).abs().max()) / (
                float(w_.float().abs().max()) + 1e-12)
            assert err <= BF16_TOL, (k, err)
        w2 = state["params"]["softmax_w"][2]
        if k == 0:
            frozen = w2.clone()
        elif k < 4:                      # dead at steps 1-3
            assert torch.equal(w2, frozen), k
        assert state["staleness"].device.type == "cpu"
    assert not torch.equal(state["params"]["softmax_w"][2], frozen)


def test_load_on_card_matches_cpu_rows_and_calibrates(cuda):
    """``launch.load`` on the card at the reduced width: the paged LM's
    virtual-time CSV rows equal the CPU run's (the timeline depends only
    on the trace, the costs, admission outcomes and the work), with K11,
    K8 and K6 launched; the ASR ``--wall --calibrate`` run launches K4
    once per admission and K5 once per frame, and its synchronized
    measurements fit finite, positive costs."""
    import contextlib
    import io

    from repro_torch import obs
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import load as TL

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert TL.main(argv) == 0
        torch.cuda.synchronize()
        assert not obs.enabled()
        return [ln for ln in out.getvalue().splitlines()
                if ln.count(",") >= 2]

    lm = ["--arch", "smollm-360m", "--reduced", "--cache", "paged",
          "--page-size", "4", "--qps", "30", "--horizon", "1",
          "--len-median", "8", "--patience", "0.4"]
    before = (FA.launches, DA.paged_launches, DK.argmax_launches)
    card = run(lm)
    after = (FA.launches, DA.paged_launches, DK.argmax_launches)
    assert all(a > b for a, b in zip(after, before))
    assert card == run(lm + ["--device", "cpu"])

    k4, k5 = lstm_cell.stack_launches, DK.launches
    rows = run(["--arch", "swb2000-blstm", "--reduced", "--qps", "20",
                "--horizon", "0.5", "--wall", "--calibrate"])
    vals = {ln.split(",")[0]: float(ln.split(",")[1]) for ln in rows[1:]}
    assert lstm_cell.stack_launches - k4 == vals["load/done"] > 0
    assert DK.launches - k5 == 8 * vals["load/waves"]
    for name in ("calib/admit_ms", "calib/wave_ms"):
        assert 0 < vals[name] < 1e3, (name, vals[name])
