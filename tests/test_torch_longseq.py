"""The port's sequence-chunked BLSTM training path (K1's chunk-entry
variant and the chunked-recompute backward K3, plain versions) held
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode.  Tolerances:

* y and the bf16 entry carries within one bf16 rounding of JAX's, f32
  carries within 1e-5 normalised (docs/kernels.md, f32 forward): XLA's
  CPU ``tanh`` and ``logistic`` differ from PyTorch's by 1-2 ulp, which
  moves an f32 carry by an ulp and, rarely, flips the bf16 rounding of an
  output.  Within the port y is held bit for bit against the stashing
  forward.
* the chunked backward's f32 dWx, dWh, db and its dx within 2e-5
  normalised of the unchunked backward's (f32 stash;
  ``tests/test_longseq.py``'s contract; the two sum the weight gradients
  in another order, so once cast to bf16 they may sit a rounding apart);
  the layer's parameter gradients within 2e-2 of JAX's chunked VJP (the
  K2 tolerance of ``tests/test_torch_train_kernels.py``);
* ``loss_train`` within 2e-2 of JAX's (``tests/test_torch_train_model.py``);
  a 3-step ad_psgd trajectory's losses within 5e-5 of JAX's and its
  parameters within 2e-2 (``tests/test_torch_train_step.py``; the
  unchunked trajectory's worst leaf sits 7e-4 from JAX's, as this one's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.kernels import lstm_cell as jlc  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim.optimizers import get_optimizer as jax_optimizer  # noqa: E402
from repro.optim.schedules import paper_recipe as jax_recipe  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.kernels import lstm_cell as tlc  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedules import paper_recipe  # noqa: E402
from repro_torch.params import from_jax_params, from_jax_state  # noqa: E402

B, D, H = 5, 8, 16
BF16_TOL = 2e-2
F32_FWD_TOL = 1e-5
CHUNK_TOL = 2e-5
LOSS_TOL = 5e-5
LENGTHS = (11, 3, 7, 1, 5)        # a length-1 row; 3 < T - K masks chunks


def _norm_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-12)


def _within_bf16_ulp(got, want):
    """Every element equal to JAX's or one bf16 rounding away."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(np.float32(1), e - 8)          # 8 significant bits
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def _t(a):
    return from_jax_params({"a": np.asarray(a)})["a"]


def _inputs(seed, T):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(D, 4 * H), w(H, 4 * H),
               jnp.asarray(rng.normal(size=(4 * H,)) * 0.1, jnp.float32)]
    return ws, w(B, T, D, scale=1.0)


# ---------------------------------------------------------------------------
# accounting and the chunk-length rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [0, 1, 5, 64, 256])
def test_stash_bytes_equals_reference(K):
    for b in (1, 3, 32):
        for T in (1, 13, 21, 2000, 8000):
            for h in (16, 512):
                for n_dir in (1, 2):
                    for itemsize in (2, 4):
                        kw = dict(n_dir=n_dir, stash_itemsize=itemsize,
                                  seq_chunk=K)
                        assert tlc.stash_bytes(b, T, h, **kw) == \
                            jlc.stash_bytes(b, T, h, **kw)


@pytest.mark.parametrize("seq_chunk", [-1, 4, 5, 64])
def test_chunk_length_matches_auto_tile(seq_chunk):
    """K as ``auto_tile`` picks it where its VMEM rule does not bind
    (small widths), and T padded to a multiple of it."""
    for T in list(range(1, 70)) + [255, 256, 257, 260, 300, 1000, 2000]:
        _, want = jlc.auto_tile(4, T, D, H, 2, n_dir=2, seq_chunk=seq_chunk)
        K = tlc.chunk_length(T, seq_chunk)
        assert K == want, (T, K, want)
        if seq_chunk > 0:
            assert K == min(seq_chunk, T)
    assert tlc.chunk_length(2000, -1) == 256
    assert -(-2000 // 256) * 256 == 2048
    with pytest.raises(ValueError, match="seq_chunk 0"):
        tlc.chunk_length(10, 0)


# ---------------------------------------------------------------------------
# K1's chunk-entry variant (plain) against the Pallas forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stash", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K", [(12, 4), (13, 5)])
def test_chunk_entry_forward_matches_jax(T, K, stash):
    """y and the (h, c) entry carries of both directions against
    ``_run_fwd(stash=True, seq_chunk=K)`` on the time-padded input, in
    the same (direction, recurrence chunk) order."""
    ws, x = _inputs(T, T)
    lens = np.array([T, T - 3, 1, 5, T - K], np.int32)
    Tp = -(-T // K) * K
    outs, _ = jlc._run_fwd(
        ((ws[0], ws[1], ws[2]), (ws[3], ws[4], ws[5])),
        jnp.pad(x, ((0, 0), (0, Tp - T), (0, 0))), (False, True),
        stash=True, block_b=None, vmem_budget=None, interpret=True,
        lengths=jnp.asarray(lens), stash_dtype=stash, seq_chunk=K)
    tw = [_t(w).unsqueeze(0) for w in ws]
    tl = torch.from_numpy(lens).unsqueeze(0)
    y, hb, cb = tlc.blstm_layer_train_chunked(*tw, _t(x).unsqueeze(0), tl,
                                              chunk=K, stash=stash)
    n = Tp // K
    assert y.shape == (1, B, T, 2 * H) and y.dtype == torch.bfloat16
    assert hb.shape == cb.shape == (2, 1, B, n, H)
    assert hb.dtype == cb.dtype == getattr(torch, stash)
    for d in range(2):
        _within_bf16_ulp(y[0, ..., d * H:(d + 1) * H].float(),
                         outs[d][:B, :T])
        for got, want in ((hb[d, 0], outs[2 + 2 * d][:B]),
                          (cb[d, 0], outs[3 + 2 * d][:B])):
            if stash == "bfloat16":
                _within_bf16_ulp(got.float(), want)
            else:
                assert _norm_err(got, want) <= F32_FWD_TOL
    assert not hb[:, :, :, 0].any() and not cb[:, :, :, 0].any()
    # within the port: the chunk variant's y is the stashing forward's
    y_stash, _, _ = tlc.blstm_layer_train(*tw, _t(x).unsqueeze(0), tl,
                                          stash=stash)
    assert torch.equal(y, y_stash)


# ---------------------------------------------------------------------------
# the chunked layer VJP
# ---------------------------------------------------------------------------

def _port_grads(ws, x, lengths, cot, seq_chunk, stash):
    leaves = [_t(w).unsqueeze(0).requires_grad_(True) for w in ws]
    xt = _t(x).unsqueeze(0).requires_grad_(True)
    tl = (None if lengths is None
          else torch.tensor([lengths], dtype=torch.int32))
    y = tlc.blstm_sequence(*leaves, xt, tl, stash_dtype=stash,
                           seq_chunk=seq_chunk)
    (y.float() * _t(cot).float()).sum().backward()
    return [g.grad[0] for g in leaves + [xt]]


@pytest.mark.parametrize("lengths,seq_chunk,stash", [
    (None, 4, "float32"),          # dense: synthesized lengths, T padded
    (LENGTHS, 4, "float32"),
    (LENGTHS, -1, "float32"),      # auto K (16 > T: one padded chunk)
    (LENGTHS, 3, "bfloat16"),
])
def test_chunked_grads_match_unchunked_and_jax(lengths, seq_chunk, stash):
    """The chunked backward's dWx, dWh, db (both directions) and dx
    against the unchunked backward's on the same input and cotangent, and
    the chunked layer's parameter gradients against ``jax.grad`` of the
    reference's chunked ``blstm_sequence``."""
    T = 11
    ws, x = _inputs(20 + seq_chunk, T)
    cot = jnp.asarray(np.random.default_rng(3).normal(size=(B, T, 2 * H)),
                      jnp.bfloat16)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def f(*args):
        y = jlc.blstm_sequence(*args, jl, interpret=True, seq_chunk=seq_chunk,
                               stash_dtype=stash)
        return jnp.sum(y.astype(jnp.float32) * cot.astype(jnp.float32))

    want = jax.grad(f, argnums=tuple(range(7)))(*ws, x)
    got = _port_grads(ws, x, lengths, cot, seq_chunk, stash)
    for g, w in zip(got, want):
        assert _norm_err(g.float().numpy(), w) <= BF16_TOL
    if lengths is not None:             # padded frames get no dx
        for b, n in enumerate(lengths):
            assert not got[6][b, n:].any()

    # the wrappers' own outputs: f32 weight gradients and dx
    tw = [_t(w).unsqueeze(0) for w in ws]
    xt, dy = _t(x).unsqueeze(0), _t(cot).unsqueeze(0)
    tl = (None if lengths is None
          else torch.tensor([lengths], dtype=torch.int32))
    K = tlc.chunk_length(T, seq_chunk)
    y, hb, cb = tlc.blstm_layer_train_chunked(*tw, xt, tl, chunk=K,
                                              stash=stash)
    dx_c, g_c = tlc.blstm_layer_bwd_chunked(*tw, xt, y, hb, cb, dy, tl,
                                            chunk=K)
    y_u, acts, cseq = tlc.blstm_layer_train(*tw, xt, tl, stash=stash)
    dx_u, g_u = tlc.blstm_layer_bwd(tw[0], tw[1], tw[3], tw[4], xt, y_u,
                                    acts, cseq, dy, tl)
    assert torch.equal(y, y_u)
    tol = CHUNK_TOL if stash == "float32" else BF16_TOL
    pairs = [(dx_c, dx_u)] + [(a, b) for d in range(2)
                              for a, b in zip(g_c[d], g_u[d])]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _norm_err(a.float().numpy(), b.float().numpy()) <= tol


def test_chunked_layer_saves_no_per_step_stash():
    """The chunked VJP keeps x, y, the lengths and the entry carries: no
    saved tensor has a per-step gate or cell axis."""
    T, K = 12, 4
    ws, x = _inputs(30, T)
    leaves = [_t(w).unsqueeze(0).requires_grad_(True) for w in ws]
    y = tlc.blstm_sequence(*leaves, _t(x).unsqueeze(0), seq_chunk=K)
    shapes = [tuple(t.shape) for t in y.grad_fn.saved_tensors]
    w = [(1, D, 4 * H), (1, H, 4 * H), (1, 4 * H)]
    assert shapes == w + w + [(1, B, T, D), (1, B, T, 2 * H),
                              (2, 1, B, T // K, H), (2, 1, B, T // K, H),
                              (1, B)], shapes
    before = (tlc.chunk_launches, tlc.chunked_bwd_launches)
    y.float().sum().backward()
    # CPU tensors take the plain versions: no kernel launch counted
    assert (tlc.chunk_launches, tlc.chunked_bwd_launches) == before
    assert all(w.grad is not None for w in leaves)


# ---------------------------------------------------------------------------
# model, step and CLI
# ---------------------------------------------------------------------------

def _requires_grad(tree, leaves):
    if isinstance(tree, dict):
        return {k: _requires_grad(v, leaves) for k, v in tree.items()}
    t = tree.detach().requires_grad_(True)
    leaves.append(t)
    return t


@pytest.mark.parametrize("lengths", [None, (6, 2, 5, 1)])
def test_loss_train_seq_chunk_per_learner_matches_jax(lengths):
    """Two stacked learners with different weights, ``lstm_seq_chunk=4``:
    each learner's loss and gradients against ``jax.value_and_grad`` of
    the reference's chunked ``loss_train`` on that learner's weights and
    rows."""
    jcfg = dataclasses.replace(jax_get_arch("swb2000-blstm").reduced(),
                               lstm_seq_chunk=4)
    tcfg = dataclasses.replace(get_arch("swb2000-blstm").reduced(),
                               lstm_seq_chunk=4)
    jparams = [init_spec_tree(jlstm.param_specs(jcfg),
                              jax.random.PRNGKey(k)) for k in (0, 1)]
    rng = np.random.default_rng(5)
    Bt, T = 4, 6
    batch = {"features": rng.normal(size=(Bt, T, jcfg.input_dim)).astype(
                 np.float32),
             "labels": rng.integers(0, jcfg.vocab, size=(Bt, T)).astype(
                 np.int32)}
    if lengths is not None:
        batch["lengths"] = np.asarray(lengths, np.int32)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), *jparams)
    leaves = []
    tparams = _requires_grad(from_jax_params(stacked), leaves)
    lb = TS.split_learner_batch({k: torch.from_numpy(v)
                                 for k, v in batch.items()}, 2)
    got = tlstm.loss_train(tcfg, tparams, lb, device="cpu")
    assert got.shape == (2,)
    got.sum().backward()
    for l in range(2):
        one = {k: jnp.asarray(v[2 * l:2 * l + 2]) for k, v in batch.items()}
        want, grads = jax.value_and_grad(lambda p: jlstm.loss_train(
            jcfg, p, one, kernel_impl="pallas"))(jparams[l])
        assert abs(float(got[l].detach()) - float(want)) <= \
            BF16_TOL * abs(float(want))
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            t = tparams
            for p in path:
                t = t[p.key]
            assert _norm_err(t.grad[l].float().numpy(), leaf) <= BF16_TOL, \
                path


def test_ad_psgd_seq_chunk_trajectory_matches_jax():
    """Three ad_psgd steps of the reduced model with ``--seq-chunk 4`` on
    variable-length batches, from the same state in both packages."""
    jcfg = dataclasses.replace(jax_get_arch("swb2000-blstm").reduced(),
                               lstm_seq_chunk=4)
    tcfg = dataclasses.replace(get_arch("swb2000-blstm").reduced(),
                               lstm_seq_chunk=4)
    n = 2
    jstrat = JS.get_strategy("ad_psgd")
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0)), n)
    jopt = jax_optimizer("sgd")
    jstate = JS.init_state(jstrat, params, jopt)
    jstep = jax.jit(JS.make_train_step(
        jstrat, lambda p, b: jlstm.loss_train(jcfg, p, b,
                                              kernel_impl="pallas"),
        jopt, jax_recipe(3, 0.05, 0.2), n_learners=n))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    tstep = TS.make_train_step(
        TS.get_strategy("ad_psgd"),
        lambda p, b: tlstm.loss_train(tcfg, p, b, device="cpu"),
        get_optimizer("sgd"), paper_recipe(3, 0.05, 0.2), n_learners=n)
    ds = jax_make_dataset(jcfg, seq_len=10, batch=4, seed=0, var_len=True)
    for k in range(3):
        batch = ds.batch_at(k)
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= LOSS_TOL * abs(want), k
    for key in ("params", "prev_params"):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jstate[key]))[0]
        for path, want in flat:
            got = tstate[key]
            for p in path:
                got = got[p.key]
            assert _norm_err(got.float().numpy(), want) <= BF16_TOL, \
                (key, jax.tree_util.keystr(path))


def test_cli_seq_chunk_prints_chunk_and_stash(capsys):
    TT.main(["--reduced", "--device", "cpu", "--seq-chunk", "4",
             "--var-len", "--steps", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith("stash:"))
    cfg = get_arch("swb2000-blstm").reduced()
    batch = max(8, 2 * cfg.n_learners)
    per_layer = tlc.stash_bytes(batch, 21, cfg.lstm_hidden, n_dir=2,
                                seq_chunk=4)
    assert "seq_chunk K=4" in line and "T_pad=24" in line, line
    assert f"{per_layer} B per layer" in line, line
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
