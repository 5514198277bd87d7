"""The port's distributed train step and CLI held against the JAX package
on the CPU.

Both packages start from the same JAX train state (carried over with
``repro_torch.params.from_jax_state``) and take three steps on the same
synthetic batches; losses agree within 2e-2 relative and parameters within
2e-2 normalised by the reference's max-abs (the bf16 gradient tolerance
of docs/kernels.md §Oracle tolerances).
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
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim.optimizers import get_optimizer as jax_optimizer  # noqa: E402
from repro.optim.schedules import paper_recipe as jax_recipe  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedules import paper_recipe  # noqa: E402
from repro_torch.params import from_jax_state  # noqa: E402

TOL = 2e-2
L = 2


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _params_close(jparams, tparams, scale=None):
    """Leafwise within TOL of the reference, normalised by the max-abs of
    the same leaf of ``scale`` (default: the reference leaf itself)."""
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    for path, want in flat:
        got = _leaf(tparams, path)
        assert got.dtype == from_jax_state({"params": {"a": want}})[
            "params"]["a"].dtype
        want = want.astype(np.float32)
        ref = want if scale is None else np.asarray(
            _leaf(scale, path)).astype(np.float32)
        err = np.abs(got.float().numpy() - want).max() / (
            np.abs(ref).max() + 1e-12)
        assert err <= TOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name,optimizer,microbatches,var_len", [
    ("ad_psgd", "sgd", 1, True),        # the paper's main path
    ("sd_psgd", "momentum", 2, True),
    ("sc_psgd", "sgd", 1, False),
    ("downpour", "sgd", 1, False),
])
def test_trajectory_matches_jax(name, optimizer, microbatches, var_len):
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    jstrat = JS.get_strategy(name)
    n = L if jstrat.replicated else 1
    params = init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0))
    if jstrat.replicated:
        params = JS.stack_for_learners(params, n)
    jopt = jax_optimizer(optimizer)
    jstate = JS.init_state(jstrat, params, jopt)
    jstep = jax.jit(JS.make_train_step(
        jstrat, lambda p, b: jlstm.loss_train(jcfg, p, b,
                                              kernel_impl="pallas"),
        jopt, jax_recipe(3, 0.05, 0.2), n_learners=n,
        microbatches=microbatches))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    assert tstate["step"] == 0 and set(tstate) == set(jstate)
    tstep = TS.make_train_step(
        TS.get_strategy(name),
        lambda p, b: tlstm.loss_train(tcfg, p, b, device="cpu"),
        get_optimizer(optimizer), paper_recipe(3, 0.05, 0.2), n_learners=n,
        microbatches=microbatches)
    ds = jax_make_dataset(jcfg, seq_len=8, batch=4, seed=0, var_len=var_len)
    for k in range(3):
        batch = ds.batch_at(k)
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= TOL * abs(want), k
        if "wire_bytes" in jm:
            assert float(tm["wire_bytes"]) == float(jm["wire_bytes"])
    assert tstate["step"] == 3
    _params_close(jstate["params"], tstate["params"])
    if jstrat.stale:
        _params_close(jstate["prev_params"], tstate["prev_params"])


def test_bmuf_block_sync_matches_jax():
    """BMUF with a 2-step block: local steps, then the block sync."""
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    jstrat = dataclasses.replace(JS.get_strategy("bmuf"), block_size=2)
    tstrat = dataclasses.replace(TS.get_strategy("bmuf"), block_size=2)
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(1)), L)
    jopt = jax_optimizer("sgd")
    jstate = JS.init_state(jstrat, params, jopt)
    jstep = jax.jit(JS.make_train_step(
        jstrat, lambda p, b: jlstm.loss_train(jcfg, p, b), jopt,
        jax_recipe(3, 0.05, 0.2), n_learners=L))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    tstep = TS.make_train_step(
        tstrat, lambda p, b: tlstm.loss_train(tcfg, p, b, device="cpu"),
        get_optimizer("sgd"), paper_recipe(3, 0.05, 0.2), n_learners=L)
    ds = jax_make_dataset(jcfg, seq_len=6, batch=4, seed=1, var_len=True)
    for k in range(2):
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in ds.batch_at(k).items()})
        tstate, tm = tstep(tstate, ds.batch_at(k))
        assert float(tm["wire_bytes"]) == float(jm["wire_bytes"])
    assert float(tm["wire_bytes"]) > 0          # step 2 synced
    for key in ("params", "anchor"):
        _params_close(jstate[key], tstate[key])
    # the block momentum is a difference of bf16 parameters: held at the
    # parameters' scale, where one bf16 rounding step of them lies
    _params_close(jstate["block_mom"], tstate["block_mom"],
                  scale=jstate["anchor"])


def test_from_jax_state_carries_every_leaf():
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0)), L)
    jstate = JS.init_state(JS.get_strategy("ad_psgd"), params,
                           jax_optimizer("adam"))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    assert tstate["opt"]["t"].shape == (L,)
    assert tstate["opt"]["t"].dtype == torch.int32
    w = tstate["prev_params"]["layers"]["layer_0"]["fwd"]["wx"]
    assert w.dtype == torch.bfloat16 and w.shape[0] == L
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jstate["prev_params"]["layers"]["layer_0"]["fwd"]["wx"],
                   np.float32))
    with pytest.raises(ValueError, match="elastic"):
        from_jax_state({"staleness": np.zeros(L, np.int32)})


def test_from_jax_state_carries_comm():
    """A top-k wire's error-feedback residual and estimate (f32, here made
    non-zero by one JAX step) come over bit for bit."""
    from repro.core.transport import Transport as JT

    jcfg = jax_get_arch("swb2000-blstm").reduced()
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0)), L)
    jt = JT(topology="ring", wire="topk", topk_frac=0.1)
    jstate = JS.init_state(JS.get_strategy("ad_psgd"), params,
                           jax_optimizer("sgd"), transport=jt)
    _, jstate["comm"] = jt.make_mixer(L)(params, jnp.int32(0),
                                        jstate["comm"])
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jstate["comm"]))[0]
    assert {p[0].key for p, _ in flat} == {"residual", "estimate"}
    for path, want in flat:
        got = _leaf(tstate["comm"], path)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert got.numpy().tobytes() == want.tobytes()
    assert any(np.abs(w).max() > 0 for _, w in flat)


def _cli_lines(capsys, argv):
    TT.main(argv)
    out = capsys.readouterr().out.splitlines()
    return out, [l for l in out if l.startswith(("step", "final loss"))]


def test_cli_cpu_reduced(capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "2"]
    out, lines = _cli_lines(capsys, argv)
    assert any(l.startswith("final loss") for l in out), out
    assert any(l.startswith("timing: first step") for l in out), out
    loss = float(lines[-1].split()[-1])
    assert np.isfinite(loss)
    _, again = _cli_lines(capsys, argv)
    assert [l.split("(")[0] for l in again] == \
        [l.split("(")[0] for l in lines]          # same seed, same losses
    _, other = _cli_lines(capsys, argv[:-1] + ["1", "--seed", "1"])
    assert other[-1] != lines[-1]


def test_cli_var_len_logs_pad_efficiency(capsys):
    out, lines = _cli_lines(capsys, ["--reduced", "--device", "cpu",
                                     "--steps", "2", "--log-every", "1",
                                     "--var-len", "--stash-dtype",
                                     "bfloat16", "--strategy", "sd_psgd"])
    assert lines[0].startswith("step     0 loss") and "pad_eff" in lines[0]
    assert "wire" in lines[0]
    assert "[sd_psgd, L=2, cpu]" in "\n".join(out)


def test_prefetcher_reraises_worker_errors():
    class Broken:
        def batch_at(self, step):
            if step == 1:
                raise KeyError("boom")
            return step

    pf = Prefetcher(Broken())
    try:
        assert pf.next() == 0
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            pf.next()
    finally:
        pf.close()
    assert not pf.thread.is_alive()
