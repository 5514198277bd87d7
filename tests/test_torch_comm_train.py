"""The port's train step over the compressed and hierarchical transports
held against JAX's ``make_train_step`` on the CPU: ``hring`` (4 learners,
pods of 2, bf16 intra-pod, int8 inter-pod), ``ad_psgd_q8``,
``ad_psgd_exp`` and ``ad_psgd`` over a bucketed top-k wire.

At every step of the JAX run, the transport's mixer is held bit for bit
on the JAX state's own params and comm (the same inputs on both sides).
The trajectories themselves differ by the bf16 gradient tolerance
(docs/kernels.md §Oracle tolerances), and a 1e-5 gradient difference can
swap which entries a top-k wire ships, so losses, grad norms and the
final params are held at 2e-2 (relative, normalised by the reference's
max-abs); the top-k run's error-feedback estimate likewise, and its
residual, which holds only the entries left unsent, at 2e-2 of the
estimate's scale.  ``consensus`` is held within 1e-6 relative on the JAX
run's params, and the gradient norms within 1e-6 on one gradient tree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim.optimizers import get_optimizer as jax_optimizer  # noqa: E402
from repro.optim.schedules import paper_recipe as jax_recipe  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import transport as ttr  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedules import paper_recipe  # noqa: E402
from repro_torch.params import from_jax_state  # noqa: E402

TOL = 2e-2
EXACT_TOL = 1e-6
L = 4

CASES = {
    "hring": ("hring", dict(topology="hierarchical", pod_size=2,
                            intra_wire="bf16", wire="int8")),
    "ad_psgd_q8": ("ad_psgd_q8", dict(topology="ring", wire="int8")),
    "ad_psgd_exp": ("ad_psgd_exp", dict(topology="exp")),
    "ad_psgd_topk": ("ad_psgd", dict(topology="ring", wire="topk",
                                     bucket_bytes=4096)),
}


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0]


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _close(jtree, ttree, tol, scale=None, what=""):
    """Leafwise within ``tol`` of the reference, normalised by the max-abs
    of the same leaf of ``scale`` (default: the reference leaf)."""
    for path, want in _flat(jtree):
        got = _get(ttree, path).float().numpy()
        want = want.astype(np.float32)
        ref = want if scale is None else np.asarray(
            _get(scale, path)).astype(np.float32)
        err = np.abs(got - want).max() / (np.abs(ref).max() + 1e-12)
        assert err <= tol, (what, jax.tree_util.keystr(path), err)


def _bits_equal(jtree, ttree, what):
    for path, want in _flat(jtree):
        got = _get(ttree, path)
        ref = from_jax_state({"params": {"a": want}})["params"]["a"]
        assert got.dtype == ref.dtype, (what, path)
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got, ref.view(torch.int16)
                           if ref.dtype == torch.bfloat16 else ref), \
            (what, jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", sorted(CASES))
def test_comm_trajectory_matches_jax(case):
    name, kw = CASES[case]
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    jt, tt = jtr.Transport(**kw), ttr.Transport(**kw)
    jstrat = JS.get_strategy(name)
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(3)), L)
    jopt = jax_optimizer("sgd")
    jstate = JS.init_state(jstrat, params, jopt, transport=jt)
    jstep = jax.jit(JS.make_train_step(
        jstrat, lambda p, b: jlstm.loss_train(jcfg, p, b), jopt,
        jax_recipe(3, 0.05, 0.2), n_learners=L, transport=jt,
        with_consensus=True, with_grad_norm=True))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    assert set(tstate) == set(jstate)
    assert ("comm" in tstate) == tt.needs_state
    tstep = TS.make_train_step(
        TS.get_strategy(name),
        lambda p, b: tlstm.loss_train(tcfg, p, b, device="cpu"),
        get_optimizer("sgd"), paper_recipe(3, 0.05, 0.2), n_learners=L,
        transport=tt, with_consensus=True, with_grad_norm=True)
    jmix, tmix = jt.make_mixer(L), tt.make_mixer(L)
    ds = jax_make_dataset(jcfg, seq_len=8, batch=2 * L, seed=4, var_len=True)
    for k in range(3):
        # the mixer on the JAX state's own params and comm: bit for bit
        same = from_jax_state(jax.tree.map(np.asarray, jstate))
        want, wcomm = jmix(jstate["params"], jstate["step"],
                           jstate.get("comm", {}))
        got, gcomm = tmix(same["params"], same["step"], same.get("comm", {}))
        _bits_equal(want, got, f"step {k} mixed")
        _bits_equal(wcomm, gcomm, f"step {k} comm")

        batch = ds.batch_at(k)
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= TOL * abs(want), (k, key)
        assert float(tm["wire_bytes"]) == float(jm["wire_bytes"])
        want = float(jm["consensus"])
        got = float(TS.consensus_distance(from_jax_state(
            jax.tree.map(np.asarray, {"params": jstate["params"]}))[
                "params"]))
        assert abs(got - want) <= EXACT_TOL * want, (k, got, want)
        assert abs(float(tm["consensus"]) - want) <= TOL * want, \
            (k, float(tm["consensus"]), want)
    assert tstate["step"] == 3
    _close(jstate["params"], tstate["params"], TOL, what="params")
    _close(jstate["prev_params"], tstate["prev_params"], TOL,
           what="prev_params")
    if "comm" in jstate:
        _close(jstate["comm"]["estimate"], tstate["comm"]["estimate"], TOL,
               what="estimate")
        _close(jstate["comm"]["residual"], tstate["comm"]["residual"], TOL,
               scale=jstate["comm"]["estimate"], what="residual")


def test_grad_norms_match_jax_on_one_tree():
    rng = np.random.default_rng(12)
    g = {"a": {"w": jnp.asarray(rng.normal(size=(3, 7, 5)), jnp.bfloat16)},
         "b": jnp.asarray(rng.normal(size=(3, 11)), jnp.float32)}
    tg = from_jax_state(jax.tree.map(np.asarray, {"params": g}))["params"]
    want = np.asarray(JS._grad_norm_stacked(g))
    got = TS._grad_norm_stacked(tg).numpy()
    np.testing.assert_allclose(got, want, rtol=EXACT_TOL)
    one = jax.tree.map(lambda x: x[0], g)
    assert abs(float(TS._grad_norm(jax.tree.map(lambda x: x[0], tg)))
               - float(JS._grad_norm(one))) <= \
        EXACT_TOL * float(JS._grad_norm(one))


def test_transport_from_cfg_resolves_every_knob():
    import dataclasses

    jcfg = jax_get_arch("swb2000-blstm")
    tcfg = get_arch("swb2000-blstm")
    for field in ("comm_topology", "comm_wire", "comm_intra_wire",
                  "comm_bucket_mb", "comm_pod_size", "comm_topk_frac",
                  "comm_staleness_lambda"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    changes = dict(comm_topology="hierarchical", comm_wire="topk",
                   comm_intra_wire="bf16", comm_bucket_mb=4,
                   comm_pod_size=4, comm_topk_frac=0.05,
                   comm_staleness_lambda=0.5)
    for name in sorted(TS.STRATEGIES):
        for ch in ({}, changes):
            want = JS.transport_from_cfg(dataclasses.replace(jcfg, **ch),
                                         JS.get_strategy(name))
            got = TS.transport_from_cfg(dataclasses.replace(tcfg, **ch),
                                        TS.get_strategy(name))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
