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


# odd shapes: B not a multiple of the tile, H < 512 and not a multiple of
# 32, T = 1, a length-0 row, three learners
TRAIN_SHAPES = [
    (1, 3, 7, 12, 16, None),
    (3, 3, 7, 12, 16, [(7, 4, 1), (0, 7, 3), (2, 2, 2)]),
    (2, 5, 1, 40, 48, [(1, 0, 1, 1, 1), (1, 1, 0, 1, 1)]),
    (3, 9, 5, 33, 100, [(5, 1, 2, 3, 4, 5, 5, 4, 0)] * 3),
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
