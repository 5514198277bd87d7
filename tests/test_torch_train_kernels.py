"""The port's BLSTM training path (K1's stashing forward and K2, plain
versions) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (docs/kernels.md §Oracle tolerances, normalised by the
oracle's max-abs): bf16 forward and stash 2e-2, bf16 gradients 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import lstm_cell as jlc  # noqa: E402
from repro_torch.kernels import lstm_cell as tlc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

B, T, D, H = 3, 7, 12, 16
BF16_TOL = 2e-2
LENGTHS = (7, 4, 1)


def _norm_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-8
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"normalised max error {err:.3g} > {tol}"


def _t(a):
    return from_jax_params({"a": np.asarray(a)})["a"]


def _f32(t):
    return t.float().numpy()


def _inputs(seed, lead=()):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return jnp.asarray(rng.normal(size=lead + shape) * scale,
                           jnp.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(D, 4 * H), w(H, 4 * H),
               jnp.asarray(rng.normal(size=lead + (4 * H,)) * 0.1,
                           jnp.float32)]
    return ws, w(B, T, D, scale=1.0)


@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_stash_forward_matches_jax_kernel(stash, lengths):
    """(y, acts, cseq) of the plain stashing forward against the Pallas
    ``_run_fwd(stash=True)`` in interpret mode, both directions."""
    ws, x = _inputs(0)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    outs, _ = jlc._run_fwd(((ws[0], ws[1], ws[2]), (ws[3], ws[4], ws[5])),
                           x, (False, True), stash=True, block_b=None,
                           vmem_budget=None, interpret=True, lengths=jl,
                           stash_dtype=stash)
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    y, acts, cseq = tlc.blstm_layer_train(
        *(_t(w) for w in ws), _t(x).unsqueeze(0),
        None if tl is None else tl.unsqueeze(0), stash=stash)
    assert y.shape == (1, B, T, 2 * H) and y.dtype == torch.bfloat16
    assert acts.shape == (2, 1, B, T, 4 * H) and cseq.shape == (2, 1, B, T, H)
    assert acts.dtype == cseq.dtype == getattr(torch, stash)
    for d in range(2):
        _norm_close(_f32(y[0, ..., d * H:(d + 1) * H]), outs[d][:B],
                    BF16_TOL)
        _norm_close(_f32(acts[d, 0]), outs[2 + 2 * d][:B], BF16_TOL)
        _norm_close(_f32(cseq[d, 0]), outs[3 + 2 * d][:B], BF16_TOL)
    # the stash variant's y is the inference forward's
    assert torch.equal(y[0], tlc.blstm_layer(*(_t(w) for w in ws), _t(x),
                                             tl))


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_layer_vjp_matches_jax_grad(lengths):
    """The autograd function's gradients against ``jax.grad`` of the
    Pallas ``blstm_sequence`` (custom VJP, interpret mode)."""
    ws, x = _inputs(1)
    cot = jnp.asarray(np.random.default_rng(2).normal(size=(B, T, 2 * H)),
                      jnp.bfloat16)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def f(*args):
        y = jlc.blstm_sequence(*args, jl, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * cot.astype(jnp.float32))

    want = jax.grad(f, argnums=tuple(range(7)))(*ws, x)
    leaves = [_t(w).unsqueeze(0).requires_grad_(True) for w in ws]
    xt = _t(x).unsqueeze(0).requires_grad_(True)
    tl = None if lengths is None else torch.tensor([lengths],
                                                   dtype=torch.int32)
    y = tlc.blstm_sequence(*leaves, xt, tl)
    (y.float() * _t(cot).float()).sum().backward()
    for got, w in zip(leaves + [xt], want):
        assert got.grad.dtype == got.dtype
        _norm_close(_f32(got.grad[0]), w, BF16_TOL)


def test_learner_axis_is_per_learner():
    """Two learners stacked give each learner's own forward and grads."""
    ws, x = _inputs(3, lead=(2,))
    lens = torch.tensor([[7, 4, 1], [3, 7, 0]], dtype=torch.int32)

    def grads(leaves, xs, ls):
        leaves = [w.detach().requires_grad_(True) for w in leaves]
        xs = xs.detach().requires_grad_(True)
        y = tlc.blstm_sequence(*leaves, xs, ls, stash_dtype="bfloat16")
        y.float().square().sum().backward()
        return y, [w.grad for w in leaves] + [xs.grad]

    y2, g2 = grads([_t(w) for w in ws], _t(x), lens)
    for l in range(2):
        y1, g1 = grads([_t(w)[l:l + 1] for w in ws], _t(x)[l:l + 1],
                       lens[l:l + 1])
        assert torch.equal(y2[l], y1[0])
        for a, b in zip(g2, g1):
            assert torch.equal(a[l], b[0])


def test_bwd_ref_zero_on_padded_steps():
    """Padded steps get zero dx; a length-0 row contributes nothing."""
    ws, x = _inputs(4)
    wx, wh, b = (_t(w) for w in ws[:3])
    lens = torch.tensor([7, 0, 3], dtype=torch.int32)
    for rev in (False, True):
        y, acts, cseq = tref.lstm_direction_train_ref(wx, wh, b, _t(x), lens,
                                                      reverse=rev)
        dy = torch.ones(B, T, H, dtype=torch.bfloat16)
        dx, dwx, dwh, db = tref.lstm_direction_bwd_ref(
            wx, wh, _t(x), y, acts, cseq, dy, lens, reverse=rev)
        assert not dx[1].any() and not dx[2, 3:].any()
        assert dx[0].any() and dwx.dtype == dwh.dtype == db.dtype == \
            torch.float32


def test_stash_dtype_names():
    assert tref.stash_dtype(None) == torch.float32
    assert tref.stash_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="stash dtype"):
        tref.stash_dtype("float16")
