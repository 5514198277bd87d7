"""The port's CTC recognition path held against the JAX package on the CPU:
``models/ctc.py`` (``ctc_loss`` at f32 1e-5 relative, its gradient with
respect to the logits at 1e-4 normalised by the largest, and
``collapse_frame_labels`` exactly), ``decode.beam_decode`` (the same
hypotheses as JAX's ``beam_decode`` under both semirings and as
``decode/ref.prefix_beam_ref`` on continuous random logits, where ties
have measure zero), the byte-equal own copy of ``decode/ref.py``, and a
3-step CTC training trajectory of the reduced BLSTM against JAX's
``make_train_step`` at the bf16 tolerance 2e-2.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.decode import beam_decode as jax_beam_decode  # noqa: E402
from repro.models import ctc as jctc  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro.optim.schedules import constant as jax_constant  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.decode import beam_decode  # noqa: E402
from repro_torch.decode.ref import prefix_beam_ref  # noqa: E402
from repro_torch.models import ctc as tctc  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.params import from_jax_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def _case(seed, B, T, V, U, label_lengths, input_lengths, repeat):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(B, T, V))).astype(np.float32)
    labels = np.full((B, U), -1, np.int32)
    for b, n in enumerate(label_lengths):
        row = rng.integers(1, V, size=n)
        if repeat and n >= 2:
            row[1] = row[0]                 # a repeat needs the blank
        labels[b, :n] = row
    lab_len = np.asarray(label_lengths, np.int32)
    in_len = None if input_lengths is None else np.asarray(input_lengths,
                                                           np.int32)
    return logits, labels, lab_len, in_len


CASES = [
    # seed, B, T, V, U, label lengths, input lengths, a repeated label;
    # odd seeds pass the label lengths, even ones let them be counted
    (0, 3, 6, 5, 3, [3, 1, 0], None, False),
    (1, 3, 6, 5, 3, [3, 2, 0], [6, 4, 1], True),
    (2, 2, 1, 4, 2, [1, 0], None, False),
    (3, 4, 9, 7, 4, [4, 4, 2, 0], [9, 8, 3, 9], True),
    (4, 2, 12, 6, 5, [5, 3], [12, 7], True),
    (5, 2, 5, 3, 3, [3, 3], None, True),       # infeasible: NLL ~ 1e30
    (6, 3, 8, 6, 3, [2, 3, 1], [8, 5, 2], False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_ctc_loss_and_grad_match_jax(case):
    logits, labels, lab_len, in_len = _case(*case)
    explicit_lengths = case[0] % 2 == 1

    def jloss(x):
        return jctc.ctc_loss(x, jnp.asarray(labels),
                             jnp.asarray(lab_len) if explicit_lengths
                             else None,
                             input_lengths=None if in_len is None
                             else jnp.asarray(in_len))
    want, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tctc.ctc_loss(x, torch.from_numpy(labels),
                        torch.from_numpy(lab_len) if explicit_lengths
                        else None,
                        input_lengths=None if in_len is None
                        else torch.from_numpy(in_len))
    (grad,) = torch.autograd.grad(got, x)
    want, got = float(want), float(got.detach())
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    jgrad = np.asarray(jgrad)
    assert np.isfinite(grad.numpy()).all()
    err = np.abs(grad.numpy() - jgrad).max() / np.abs(jgrad).max()
    assert err <= GRAD_TOL, err


def test_ctc_per_learner_form_matches_vmapped_jax():
    L, B, T, V, U = 3, 2, 7, 6, 3
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(L, B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(L, B, U)).astype(np.int32)
    labels[0, 1, 2:] = -1
    lab_len = (labels >= 0).sum(-1).astype(np.int32)
    in_len = rng.integers(U + 1, T + 1, size=(L, B)).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda x, y, n, m: jctc.ctc_loss(x, y, n, input_lengths=m))(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lab_len),
        jnp.asarray(in_len)))
    got = tctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(lab_len),
                        input_lengths=torch.from_numpy(in_len))
    assert got.shape == (L,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_TOL)


def test_out_of_vocabulary_class_is_nan_as_in_jax():
    """A label equal to V (a frame class V-1 shifted by +1) is out of the
    vocabulary: the reference's ``take_along_axis`` fills NaN and so does
    the port (``torch.gather`` alone would raise)."""
    V = 5
    logits = np.random.default_rng(9).normal(size=(2, 4, V)).astype(
        np.float32)
    for labels in ([[1, V], [2, -1]], [[V, -1], [1, 2]]):
        labels = np.asarray(labels, np.int32)
        want = float(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(labels)))
        got = float(tctc.ctc_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels)))
        assert np.isnan(want) and np.isnan(got)
    ok = np.asarray([[1, V - 1], [2, -1]], np.int32)
    assert np.isfinite(float(tctc.ctc_loss(torch.from_numpy(logits),
                                           torch.from_numpy(ok))))


@pytest.mark.parametrize("max_len", [1, 3, 6, 40])
def test_collapse_frame_labels_exact(max_len):
    rng = np.random.default_rng(max_len)
    frames = rng.integers(0, 4, size=(5, 30)).astype(np.int32)
    frames[0] = 2                                 # one run
    want = jctc.collapse_frame_labels(frames, max_len)
    got = tctc.collapse_frame_labels(frames, max_len)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("semiring", ["max", "sum"])
@pytest.mark.parametrize("beam", [1, 4])
def test_beam_decode_matches_jax_and_ref(semiring, beam):
    rng = np.random.default_rng(11 + beam)
    B, T, V = 4, 12, 9
    logits = (3.0 * rng.normal(size=(B, T, V))).astype(np.float32)
    lengths = np.array([12, 7, 1, 10], np.int32)
    want = jax_beam_decode(jnp.asarray(logits), jnp.asarray(lengths),
                           beam=beam, semiring=semiring)
    got = beam_decode(logits, lengths, beam=beam, semiring=semiring,
                      device="cpu")
    assert got == want
    assert all(isinstance(t, int) for row in got for t in row)
    ref, _ = prefix_beam_ref(logits, lengths, beam=beam, semiring=semiring)
    assert got == ref


def test_decode_ref_copy_is_byte_equal():
    mine = (ROOT / "src/repro_torch/decode/ref.py").read_bytes()
    assert mine == (ROOT / "src/repro/decode/ref.py").read_bytes()


def _ctc_batch(batch, U=6):
    """Each utterance's valid frames collapsed into at most U labels."""
    out = dict(batch)
    rows = [tctc.collapse_frame_labels(lab[None, :n], U)
            for lab, n in zip(batch["labels"], batch["lengths"])]
    out["ctc"] = np.concatenate([r[0] for r in rows])
    out["ctc_lengths"] = np.concatenate([r[1] for r in rows])
    del out["labels"]
    return out


def test_ctc_training_trajectory_matches_jax():
    """ad_psgd over 2 learners with the CTC loss on var-len utterances:
    3 steps of both packages from the same state, losses within 2e-2
    relative and parameters within 2e-2 normalised."""
    L = 2
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    jstrat = JS.get_strategy("ad_psgd")
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(2)), L)
    jstate = JS.init_state(jstrat, params, jax_sgd())

    def jloss(p, b):
        logits = jlstm.forward(jcfg, p, b["features"], b["lengths"])
        return jctc.ctc_loss(logits, b["ctc"], b["ctc_lengths"],
                             input_lengths=b["lengths"])

    def tloss(p, b):
        logits = tlstm.forward(tcfg, p, b["features"], b["lengths"],
                               device="cpu")
        return tctc.ctc_loss(logits, b["ctc"], b["ctc_lengths"],
                             input_lengths=b["lengths"])
    jstep = jax.jit(JS.make_train_step(jstrat, jloss, jax_sgd(),
                                       jax_constant(0.03), n_learners=L,
                                       with_grad_norm=True))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    tstep = TS.make_train_step(TS.get_strategy("ad_psgd"), tloss, sgd(),
                               constant(0.03), n_learners=L,
                               with_grad_norm=True)
    ds = jax_make_dataset(jcfg, seq_len=8, batch=4, seed=0, var_len=True)
    for k in range(3):
        batch = _ctc_batch(ds.batch_at(k))
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert np.isfinite(want)
            assert abs(float(tm[key]) - want) <= BF16_TOL * abs(want), \
                (k, key, float(tm[key]), want)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jstate["params"]))[0]
    for path, want in flat:
        got = tstate["params"]
        for p in path:
            got = got[p.key]
        want = want.astype(np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= BF16_TOL, (jax.tree_util.keystr(path), err)
