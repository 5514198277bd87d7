"""The port's elastic (fault-tolerant) train step held against the JAX
package and against its own plain step on the CPU, its recovery, and the
train CLI under fault plans.

On the reference's quadratic toy loss (tests/test_faults.py) both
packages start from the same state (``params.from_jax_state``) and take
the same numpy batches: the trivial plan matches the port's plain step at
2e-5 over 40 steps (a matrix product where the plain mixers roll); under
fault plans without corruption the port's trajectory matches JAX's at
1e-5 over 300 steps (1e-4 over a bf16 wire, whose codec can round an
entry one bf16 ulp apart), with the staleness counters, ``n_active`` and
``n_contrib`` exactly equal.  The corruption noise is the port's own
draw, so runs with corruption are held by convergence.  The reduced
BLSTM is held against JAX over 3 elastic steps at 2e-2 (the bf16
gradient tolerance of docs/kernels.md §Oracle tolerances); the measured
distance is ~1e-3.  Kill-and-resume, through the checkpoint module and
through the CLI, is bit-exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.core.faults import (Departure as JDeparture,  # noqa: E402
                               FaultPlan as JPlan, Straggler as JStraggler)
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.optim.schedules import paper_recipe as jax_recipe  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch import checkpoint as CK  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import transport as ttr  # noqa: E402
from repro_torch.core.faults import (Departure, FaultPlan,  # noqa: E402
                                     Straggler)
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.optim.schedules import paper_recipe  # noqa: E402
from repro_torch.params import from_jax_state  # noqa: E402

W_TRUE = np.random.default_rng(7).normal(size=8).astype(np.float32)
TRIVIAL_TOL = 2e-5
JAX_TOL = 1e-5
BF16_WIRE_TOL = 1e-4
BLSTM_TOL = 2e-2


def data(seed, n=64):
    x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    return {"x": x, "y": x @ W_TRUE}


def j_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2)


def t_loss(params, batch):
    """The toy loss over stacked params and a learner-split batch: (L,)."""
    pred = torch.einsum("lbi,li->lb", batch["x"], params["w"])
    return torch.mean((pred - batch["y"]) ** 2, dim=1)


def _jfaults(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _port_state(jstate):
    return from_jax_state(jax.tree.map(np.asarray, jstate))


# ---------------------------------------------------------------------------
# The trivial plan walks the plain step's trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sd_psgd", "ad_psgd", "sc_psgd_replicated",
                                  "downpour", "hring", "bmuf"])
def test_trivial_plan_matches_plain_step(name):
    s = TS.get_strategy(name)
    L = 8
    tr = TS.default_transport(s)
    params = {"w": torch.zeros(L, 8)}
    st_p = TS.init_state(s, params, topt.sgd(), tr)
    st_e = TS.init_elastic_state(s, params, topt.sgd(), tr)
    plain = TS.make_train_step(s, t_loss, topt.sgd(), constant(0.05),
                               n_learners=L, transport=tr)
    el = TS.make_elastic_train_step(s, t_loss, topt.sgd(), constant(0.05),
                                    n_learners=L, transport=tr)
    nf = FaultPlan(L).no_fault_inputs()
    for k in range(40):
        st_p, mp = plain(st_p, data(k))
        st_e, me = el(st_e, data(k), nf)
        assert me["wire_bytes"] == np.float32(mp["wire_bytes"])
    err = float((st_e["params"]["w"] - st_p["params"]["w"]).abs().max())
    assert err <= TRIVIAL_TOL, err
    assert me["n_active"] == L and me["n_contrib"] == L
    assert me["staleness_max"] == 0
    assert st_e["staleness"].dtype == torch.int32
    assert st_e["staleness"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Elastic trajectories against JAX
# ---------------------------------------------------------------------------

CASES = {
    # the reference's acceptance plan: 1 of 8 straggling 4x, one crash
    # and rejoin, staleness-aware ring mixing
    "ad_psgd": ("ad_psgd", dict(topology="ring", staleness_lambda=0.2),
                dict(stragglers=((0, 4, 0),), departures=((1, 30, 60),))),
    "hring": ("hring", dict(topology="hierarchical", pod_size=4,
                            staleness_lambda=0.5),
              dict(stragglers=((2, 3, 0),),
                   departures=((4, 20, 80), (5, 25, 80), (6, 30, 80),
                               (7, 35, 80)))),
    "bmuf": (dataclasses.replace(TS.get_strategy("bmuf"), block_size=4),
             dict(topology="uniform", wire="int8"),
             dict(stragglers=((0, 2, 0),), departures=((3, 10, 50),),
                  drop_prob=0.2)),
    "ad_psgd_exp": ("ad_psgd_exp", dict(topology="exp"),
                    dict(departures=((5, 40, 90), (6, 40)),
                         stall_prob=0.05)),
    "sd_psgd_bf16": ("sd_psgd", dict(topology="ring", wire="bf16",
                                     staleness_lambda=0.1),
                     dict(stragglers=((1, 2, 1),), departures=((7, 5, 9),),
                          drop_prob=0.1)),
}


def _plans(L, spec):
    def build(mod_plan, mod_s, mod_d):
        return mod_plan(
            L, seed=4, stragglers=tuple(mod_s(*x) for x in
                                        spec.get("stragglers", ())),
            departures=tuple(mod_d(*x) for x in spec.get("departures", ())),
            drop_prob=spec.get("drop_prob", 0.0),
            stall_prob=spec.get("stall_prob", 0.0))
    return (build(JPlan, JStraggler, JDeparture),
            build(FaultPlan, Straggler, Departure))


def _strategies(name):
    if isinstance(name, str):
        return JS.get_strategy(name), TS.get_strategy(name)
    return (dataclasses.replace(JS.get_strategy(name.name),
                                block_size=name.block_size), name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_elastic_trajectory_matches_jax(case):
    name, kw, spec = CASES[case]
    L, steps = 8, 300
    js, ts = _strategies(name)
    jplan, tplan = _plans(L, spec)
    jt, tt = jtr.Transport(**kw), ttr.Transport(**kw)
    jstate = JS.init_elastic_state(js, JS.stack_for_learners(
        {"w": jnp.zeros((8,))}, L), jopt.sgd(), jt)
    tstate = _port_state(jstate)
    assert set(tstate) == set(jstate)
    jstep = jax.jit(JS.make_elastic_train_step(
        js, j_loss, jopt.sgd(), jconstant(0.05), n_learners=L, transport=jt,
        with_consensus=True, with_grad_norm=True))
    tstep = TS.make_elastic_train_step(
        ts, t_loss, topt.sgd(), constant(0.05), n_learners=L, transport=tt,
        with_consensus=True, with_grad_norm=True)
    crashed = {d[0] for d in spec.get("departures", ())}
    worst = 0.0
    for k in range(steps):
        faults = tplan.step_inputs(k)
        TS.check_active(faults["active"])
        before = tstate["params"]["w"].clone()
        batch = data(k)
        jstate, jm = jstep(jstate, {kk: jnp.asarray(v)
                                    for kk, v in batch.items()},
                           _jfaults(jplan.step_inputs(k)))
        tstate, tm = tstep(tstate, batch, faults)
        np.testing.assert_array_equal(tstate["staleness"].numpy(),
                                      np.asarray(jstate["staleness"]))
        for key in ("n_active", "n_contrib", "staleness_max"):
            assert tm[key] == float(jm[key]), (k, key)
        assert tm["wire_bytes"] == float(jm["wire_bytes"]), k
        # relative 1e-4, or 1e-5 absolute: at the optimum the residuals
        # (pred - y) are f32 rounding noise on both sides
        for key in ("loss", "grad_norm", "consensus"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= 1e-4 * abs(want) + 1e-5, \
                (k, key)
        worst = max(worst, float(np.abs(tstate["params"]["w"].numpy()
                                        - np.asarray(jstate["params"]["w"])
                                        ).max()))
        for i in np.where(faults["active"] == 0)[0]:   # dead: frozen
            assert torch.equal(tstate["params"]["w"][i], before[i]), (k, i)
        for i in np.where(faults["rejoin"] > 0)[0]:    # reseeded
            assert not torch.equal(tstate["params"]["w"][i], before[i])
    # measured: 2.4e-7 (exp) to 1.3e-6 (hring); the bf16 wire 1.02e-5,
    # where an f32 rounding apart can code a payload entry one bf16 ulp
    # apart on the two sides
    tol = BF16_WIRE_TOL if kw.get("wire") == "bf16" else JAX_TOL
    assert worst <= tol, worst
    assert tstate["step"] == steps and crashed


def test_rejoiner_reseeded_at_incumbent_mean_with_fresh_state():
    """A rejoining learner comes back at the incumbents' f32 mean (its
    ``prev_params`` too), with a fresh optimizer state (Adam's count
    restarts) and zero staleness."""
    L = 4
    plan = FaultPlan(L, stragglers=(Straggler(0, 3),),
                     departures=(Departure(1, 2, 5),))
    s = TS.get_strategy("ad_psgd")
    tr = ttr.Transport(topology="ring", staleness_lambda=0.2)
    state = TS.init_elastic_state(s, {"w": torch.zeros(L, 8)},
                                  topt.adam(), tr)
    step = TS.make_elastic_train_step(s, t_loss, topt.adam(),
                                      constant(0.05), n_learners=L,
                                      transport=tr)
    for k in range(5):
        state, _ = step(state, data(k), plan.step_inputs(k))
    faults = plan.step_inputs(5)
    assert faults["rejoin"][1] == 1.0
    inc = (faults["active"] * (1 - faults["rejoin"])) > 0
    w = state["params"]["w"].double()[inc]
    mu = (w.sum(0) / inc.sum()).float()
    before = {k: state[k]["w"].clone() for k in ("params", "prev_params")}
    state, m = step(state, data(5), faults)
    assert state["staleness"][1] == 0 and m["n_active"] == L
    # the reseed is visible in prev_params (the iterate the next gradient
    # is taken at), at the incumbents' mean
    np.testing.assert_allclose(state["prev_params"]["w"][1].numpy(),
                               mu.numpy(), rtol=1e-6, atol=1e-7)
    assert not torch.equal(before["params"][1], state["prev_params"]["w"][1])
    # Adam's per-learner counts: the straggler contributed at steps 0 and
    # 3, the rejoiner once since its fresh state, the others every step
    assert state["opt"]["t"].tolist() == [2, 1, 6, 6]


def test_converges_under_drops_corruption_bf16_momentum():
    L = 8
    plan = FaultPlan(L, seed=3, stragglers=(Straggler(2, 2),),
                     drop_prob=0.1, corrupt_prob=0.1, corrupt_scale=0.05)
    s = TS.get_strategy("ad_psgd")
    tr = ttr.Transport(topology="ring", wire="bf16", staleness_lambda=0.1)
    state = TS.init_elastic_state(s, {"w": torch.zeros(L, 8)},
                                  topt.momentum(), tr)
    step = TS.make_elastic_train_step(
        s, t_loss, topt.momentum(), constant(0.02), n_learners=L,
        transport=tr, fault_seed=3, with_corruption=True)
    hits = 0
    for k in range(300):
        faults = plan.step_inputs(k)
        hits += int((faults["corrupt"] > 0).sum())
        state, m = step(state, data(k), faults)
    final = TS.average_learners(state["params"])["w"].numpy()
    assert hits > 100
    assert float(np.linalg.norm(final - W_TRUE)) < 0.15
    assert np.isfinite(float(m["loss"]))


def test_staleness_counters_track_stragglers():
    L = 4
    plan = FaultPlan(L, stragglers=(Straggler(0, 4),))
    s = TS.get_strategy("sd_psgd")
    state = TS.init_elastic_state(s, {"w": torch.zeros(L, 8)}, topt.sgd())
    step = TS.make_elastic_train_step(s, t_loss, topt.sgd(), constant(0.05),
                                      n_learners=L)
    for k in range(6):
        state, m = step(state, data(k), plan.step_inputs(k))
    st = state["staleness"].numpy()
    assert st[0] == 1 and (st[1:] == 0).all()
    assert m["n_contrib"] == 3


@pytest.mark.parametrize("elastic", [False, True])
def test_pre_split_matches_split(elastic):
    L = 4
    s = TS.get_strategy("ad_psgd")
    plan = FaultPlan(L, stragglers=(Straggler(0, 2),),
                     departures=(Departure(3, 1, 3),))
    make = TS.make_elastic_train_step if elastic else TS.make_train_step
    init = TS.init_elastic_state if elastic else TS.init_state
    runs = []
    for pre in (False, True):
        step = make(s, t_loss, topt.sgd(), constant(0.05), n_learners=L,
                    pre_split=pre)
        state = init(s, {"w": torch.zeros(L, 8)}, topt.sgd())
        for k in range(4):
            batch = data(k)
            if pre:
                batch = {key: v.reshape(L, -1, *v.shape[1:])
                         for key, v in batch.items()}
            args = (plan.step_inputs(k),) if elastic else ()
            state, _ = step(state, batch, *args)
        runs.append(state["params"]["w"])
    assert torch.equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# The reduced BLSTM against JAX
# ---------------------------------------------------------------------------

def test_reduced_blstm_elastic_ad_psgd_matches_jax():
    L = 4
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    spec = dict(stragglers=((0, 2, 0),), departures=((1, 1, 2),),
                drop_prob=0.3)
    jplan, tplan = _plans(L, spec)
    kw = dict(topology="ring", staleness_lambda=0.2)
    jt, tt = jtr.Transport(**kw), ttr.Transport(**kw)
    js = JS.get_strategy("ad_psgd")
    params = JS.stack_for_learners(
        init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0)), L)
    jstate = JS.init_elastic_state(js, params, jopt.sgd(), jt)
    jstep = jax.jit(JS.make_elastic_train_step(
        js, lambda p, b: jlstm.loss_train(jcfg, p, b), jopt.sgd(),
        jax_recipe(3, 0.05, 0.2), n_learners=L, transport=jt))
    tstate = _port_state(jstate)
    tstep = TS.make_elastic_train_step(
        TS.get_strategy("ad_psgd"),
        lambda p, b: tlstm.loss_train(tcfg, p, b, device="cpu"),
        topt.sgd(), paper_recipe(3, 0.05, 0.2), n_learners=L, transport=tt)
    ds = jax_make_dataset(jcfg, seq_len=8, batch=8, seed=0, var_len=True)
    worst = 0.0
    for k in range(3):
        batch = ds.batch_at(k)
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()},
                           _jfaults(jplan.step_inputs(k)))
        tstate, tm = tstep(tstate, batch, tplan.step_inputs(k))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= BLSTM_TOL * abs(want), k
        assert tm["n_active"] == float(jm["n_active"])
        np.testing.assert_array_equal(tstate["staleness"].numpy(),
                                      np.asarray(jstate["staleness"]))
    for key in ("params", "prev_params"):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jstate[key]))[0]
        for path, want in flat:
            got = tstate[key]
            for p in path:
                got = got[p.key]
            want = want.astype(np.float32)
            err = float(np.abs(got.float().numpy() - want).max()
                        / (np.abs(want).max() + 1e-12))
            worst = max(worst, err)
            assert err <= BLSTM_TOL, (key, jax.tree_util.keystr(path), err)
    assert worst > 0.0


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def _assert_states_bitwise_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_states_bitwise_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_bitwise_equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.device == b.device, where
        assert _bits(a) == _bits(b), where
    else:
        assert a == b, where


def test_elastic_state_checkpoint_round_trip(tmp_path):
    """An elastic BLSTM state (bf16 and f32 params, prev_params, Adam's f32
    moments and int32 counts, the int32 staleness on the host) saves and
    restores bit for bit."""
    cfg = get_arch("swb2000-blstm").reduced()
    state, step, _ = TT.setup_training(cfg, strategy_name="ad_psgd",
                                       n_learners=4, optimizer_name="adam",
                                       device="cpu", elastic=True)
    plan = FaultPlan(4, stragglers=(Straggler(2, 3),),
                     departures=(Departure(0, 0, 2),))
    ds = TT.make_dataset(cfg, seq_len=6, batch=8, seed=0, var_len=True)
    for k in range(2):
        state, _ = step(state, ds.batch_at(k), plan.step_inputs(k))
    # learner 0 dead at steps 0 and 1, learner 2 idle at step 1
    assert state["staleness"].tolist() == [2, 0, 1, 0]
    dtypes = {t.dtype for t in TS._leaves(state["params"])}
    assert dtypes == {torch.bfloat16, torch.float32}
    CK.save(str(tmp_path), 2, state)
    like, _, _ = TT.setup_training(cfg, strategy_name="ad_psgd",
                                   n_learners=4, optimizer_name="adam",
                                   device="cpu", elastic=True)
    back, at = CK.restore(str(tmp_path), like)
    assert at == 2
    _assert_states_bitwise_equal(back, state)


def test_elastic_kill_and_resume_bit_exact(tmp_path):
    """The checkpoint crosses a crash window and a straggler schedule over
    a bf16 wire with momentum and corruption; the restored run matches the
    uninterrupted one bit for bit (staleness counters included)."""
    L = 4
    plan = FaultPlan(L, seed=2, stragglers=(Straggler(0, 4),),
                     departures=(Departure(1, 6, 14),), drop_prob=0.2,
                     corrupt_prob=0.3, corrupt_scale=0.1)
    s = TS.get_strategy("ad_psgd")
    tr = ttr.Transport(topology="ring", wire="bf16", staleness_lambda=0.2)
    step = TS.make_elastic_train_step(
        s, t_loss, topt.momentum(), constant(0.05), n_learners=L,
        transport=tr, fault_seed=2, with_corruption=True)

    def fresh():
        return TS.init_elastic_state(s, {"w": torch.zeros(L, 8)},
                                     topt.momentum(), tr)

    ref = fresh()
    for k in range(20):
        ref, m_ref = step(ref, data(k), plan.step_inputs(k))
    state = fresh()
    for k in range(10):
        state, _ = step(state, data(k), plan.step_inputs(k))
    CK.save(str(tmp_path), 10, state)
    del state
    state, at = CK.restore(str(tmp_path), fresh())
    for k in range(at, 20):
        state, m_res = step(state, data(k), plan.step_inputs(k))
    _assert_states_bitwise_equal(state, ref)
    assert _bits(m_res["loss"]) == _bits(m_ref["loss"])


# ---------------------------------------------------------------------------
# The train CLI under a fault plan
# ---------------------------------------------------------------------------

FAULT_ARGV = ["--reduced", "--device", "cpu", "--learners", "4",
              "--strategy", "ad_psgd", "--optimizer", "momentum",
              "--log-every", "1", "--comm-staleness-lambda", "0.2",
              "--fault-stragglers", "0:4", "--fault-departures", "1:3:6",
              "--fault-drop-prob", "0.1", "--fault-corrupt-prob", "0.3",
              "--fault-corrupt-scale", "0.1", "--fault-seed", "1"]


def _final_loss(out):
    lines = [l for l in out.splitlines() if l.startswith("final loss")]
    assert lines, out[-2000:]
    return lines[-1]


def test_cli_kill_and_resume_under_faults(tmp_path, capsys):
    full = TT.main(FAULT_ARGV + ["--steps", "7"])
    out = capsys.readouterr().out
    assert "FaultPlan(L=4, seed=1, stragglers=0:4x, departures=1@3->6" in out
    assert " act 3/4 stale " in out and " act 4/4 stale " in out
    assert full["meta"]["plan"].n_learners == 4
    assert full["state"]["staleness"].dtype == torch.int32
    ck = str(tmp_path / "ck")
    TT.main(FAULT_ARGV + ["--steps", "4", "--ckpt-dir", ck,
                          "--ckpt-every", "4"])
    capsys.readouterr()
    resumed = TT.main(FAULT_ARGV + ["--steps", "3", "--ckpt-dir", ck,
                                    "--resume"])
    out2 = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out2
    assert _final_loss(out2) == _final_loss(out)
    _assert_states_bitwise_equal(resumed["state"], full["state"])


def test_cli_switch_rule_and_flags(capsys):
    """Only the five fault flags switch to the elastic step; the others
    keep the reference's defaults."""
    ap_out = TT.main(["--reduced", "--device", "cpu", "--steps", "1",
                      "--log-every", "0", "--fault-seed", "3",
                      "--fault-corrupt-scale", "0.5",
                      "--comm-staleness-lambda", "0.3"])
    assert ap_out["meta"]["plan"] is None
    assert "staleness" not in ap_out["state"]
    assert ap_out["meta"]["transport"].staleness_lambda == \
        pytest.approx(0.3)
    for flag, value in (("--fault-stragglers", "1:2"),
                        ("--fault-departures", "0:5"),
                        ("--fault-drop-prob", "0.5"),
                        ("--fault-stall-prob", "0.5"),
                        ("--fault-corrupt-prob", "0.5")):
        got = TT.main(["--reduced", "--device", "cpu", "--steps", "1",
                       "--log-every", "0", flag, value])
        assert got["meta"]["plan"] is not None, flag
        assert "staleness" in got["state"], flag
    assert capsys.readouterr().out.count("FaultPlan(L=2") == 5
