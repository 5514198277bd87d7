"""The port's fault plans, elastic mixing matrices and elastic mixer held
against the JAX package on the CPU.

``core/faults.py`` is an own copy of the reference module (numpy only),
held byte-equal and, with its schedules, parsers and (de)serialization,
against the original.  The elastic matrices are built on the host in f32
in the reference's order and held at 1e-6 (absolute: every entry lies in
[0, 1]) against ``repro.core.mixing.elastic_matrix``; the elastic mixer's
coded payloads bit for bit, its output at 1e-6 normalised by the leaf's
max-abs on f32 leaves and to one bf16 rounding on a bf16 leaf.  The
corruption noise is the port's own draw (the reference's threefry stream
is not reproduced), so it is held by its properties.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.optim.optimizers import sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import transport as ttr  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MATRIX_TOL = 1e-6
BF16_ULP = 2.0 ** -8     # one bf16 rounding, relative

# the reference's masks (tests/test_faults.py) and a ragged pod case
MASKS = [np.ones(8, np.float32),
         np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32),
         np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float32),
         np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32),
         np.array([0, 1, 1, 0, 1, 1, 1, 0], np.float32)]
TOPOLOGIES = ["none", "ring", "uniform", "exp", "hierarchical"]


def _plan(mod, L=8):
    return mod.FaultPlan(
        L, seed=5, stragglers=(mod.Straggler(0, 4), mod.Straggler(3, 3, 1)),
        departures=(mod.Departure(1, 30, 60), mod.Departure(2, 50),
                    mod.Departure(5, 10, 11)),
        drop_prob=0.2, stall_prob=0.05, corrupt_prob=0.1,
        corrupt_scale=0.05)


def _edge_mask(rng, L):
    up = np.triu(rng.random((L, L)) >= 0.3, 1)
    ok = (up + up.T).astype(np.float32)
    np.fill_diagonal(ok, 1.0)
    return ok


# ---------------------------------------------------------------------------
# FaultPlan: the own copy
# ---------------------------------------------------------------------------

def test_faults_copy_is_byte_equal():
    ours = ROOT / "src" / "repro_torch" / "core" / "faults.py"
    theirs = ROOT / "src" / "repro" / "core" / "faults.py"
    assert ours.read_bytes() == theirs.read_bytes()


def test_step_inputs_match_jax_for_200_steps():
    jp, tp = _plan(jfaults), _plan(tfaults)
    assert tp.to_dict() == jp.to_dict()
    assert tp.describe() == jp.describe()
    np.testing.assert_array_equal(tp.speed_factors(), jp.speed_factors())
    seen = {k: 0.0 for k in ("active", "contrib", "rejoin", "edge_ok",
                             "corrupt")}
    for step in range(200):
        a, b = jp.step_inputs(step), tp.step_inputs(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
            clear = 0.0 if k in ("rejoin", "corrupt") else 1.0
            seen[k] += float(np.sum(b[k] != clear))
    # every kind of fault happened in the window
    assert all(v > 0 for v in seen.values()), seen
    for learner in range(8):
        for k in (0, 3, 77):
            assert tp.stall_extra(learner, k) == jp.stall_extra(learner, k)
    twin = tfaults.FaultPlan.from_dict(jp.to_dict())
    for step in (0, 31, 60, 199):
        for k, v in twin.step_inputs(step).items():
            np.testing.assert_array_equal(v, jp.step_inputs(step)[k])
    trivial = tp.no_fault_inputs()
    for k, v in jp.no_fault_inputs().items():
        assert trivial[k].tobytes() == v.tobytes()


@pytest.mark.parametrize("spec,want", [
    ("0:4, 3:2", ((0, 4, 0), (3, 2, 0))),
    ("", ()),
    ("7:1", ((7, 1, 0),)),
])
def test_parse_stragglers_matches_jax(spec, want):
    got = tfaults.parse_stragglers(spec)
    assert [tuple(vars(s).values()) for s in got] == list(want)
    assert [vars(s) for s in got] == \
        [vars(s) for s in jfaults.parse_stragglers(spec)]


@pytest.mark.parametrize("spec,want", [
    ("1:30:60,2:50", ((1, 30, 60), (2, 50, -1))),
    ("", ()),
    (" 0:3 ", ((0, 3, -1),)),
])
def test_parse_departures_matches_jax(spec, want):
    got = tfaults.parse_departures(spec)
    assert [tuple(vars(d).values()) for d in got] == list(want)
    assert [vars(d) for d in got] == \
        [vars(d) for d in jfaults.parse_departures(spec)]


@pytest.mark.parametrize("mod", [jfaults, tfaults], ids=["jax", "port"])
def test_plan_and_parser_refusals(mod):
    with pytest.raises(ValueError, match="straggler"):
        mod.parse_stragglers("0:4:9")
    with pytest.raises(ValueError, match="departure"):
        mod.parse_departures("1")
    with pytest.raises(ValueError, match="ZERO active"):
        mod.FaultPlan(2, departures=(mod.Departure(0, 5),
                                     mod.Departure(1, 5)))
    with pytest.raises(ValueError, match="rejoin"):
        mod.FaultPlan(2, departures=(mod.Departure(0, 5, 5),))
    with pytest.raises(ValueError, match="out of range"):
        mod.FaultPlan(2, stragglers=(mod.Straggler(5, 2),))
    with pytest.raises(ValueError, match="drop_prob"):
        mod.FaultPlan(2, drop_prob=1.5)


# ---------------------------------------------------------------------------
# Elastic matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_elastic_matrix_matches_jax(topology):
    """Every mask, several steps, λ ∈ {0, 0.5}, with and without dropped
    edges: within 1e-6 of JAX's matrix, doubly stochastic, the dead rows
    and columns identity."""
    rng = np.random.default_rng(11)
    worst = 0.0
    for mask in MASKS:
        for step in (0, 1, 2, 3, 7):
            stale = rng.integers(0, 6, 8).astype(np.float32)
            for lam in (0.0, 0.5):
                for edge in (None, _edge_mask(rng, 8)):
                    kw = dict(step=step, pod_size=4, staleness=stale,
                              staleness_lambda=lam, edge_ok=edge)
                    want = np.asarray(jmix.elastic_matrix(
                        mask, topology,
                        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()}))
                    got = tmix.elastic_matrix(mask, topology, **kw)
                    assert got.dtype == torch.float32 and got.shape == (8, 8)
                    got = got.numpy()
                    worst = max(worst, float(np.abs(got - want).max()))
                    assert tmix.is_doubly_stochastic(got, atol=1e-6), \
                        (mask, step, lam)
                    for i in np.where(mask == 0)[0]:
                        e = np.zeros(8, np.float32)
                        e[i] = 1.0
                        np.testing.assert_allclose(got[i], e, atol=1e-6)
                        np.testing.assert_allclose(got[:, i], e, atol=1e-6)
    assert worst <= MATRIX_TOL, worst


def test_elastic_constructors_match_jax_and_static():
    ones = np.ones(8, np.float32)
    for mask in MASKS:
        for j, t in ((jmix.elastic_ring_matrix(mask),
                      tmix.elastic_ring_matrix(mask)),
                     (jmix.elastic_uniform_matrix(mask),
                      tmix.elastic_uniform_matrix(mask)),
                     (jmix.elastic_hierarchical_matrix(mask, 2),
                      tmix.elastic_hierarchical_matrix(mask, 2))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=MATRIX_TOL)
        for step in range(6):
            np.testing.assert_allclose(
                tmix.elastic_exp_matrix(mask, step).numpy(),
                np.asarray(jmix.elastic_exp_matrix(mask, step)),
                atol=MATRIX_TOL)
    np.testing.assert_allclose(tmix.elastic_ring_matrix(ones).numpy(),
                               tmix.ring_matrix(8), atol=1e-6)
    np.testing.assert_allclose(tmix.elastic_uniform_matrix(ones).numpy(),
                               tmix.uniform_matrix(8), atol=1e-6)
    np.testing.assert_allclose(
        tmix.elastic_hierarchical_matrix(ones, 4).numpy(),
        tmix.hierarchical_matrix(8, 4), atol=1e-6)
    # two survivors of eight: the L = 2 ring's [2/3, 1/3]
    T = tmix.elastic_ring_matrix(np.array([1, 0, 0, 1, 0, 0, 0, 0],
                                          np.float32))
    assert float(T[0, 3]) == pytest.approx(1 / 3)
    assert float(T[0, 0]) == pytest.approx(2 / 3)
    # 4 live of 8: two exp rounds reach exact consensus
    mask = np.array([1, 1, 0, 1, 0, 0, 1, 0], np.float32)
    P = (tmix.elastic_exp_matrix(mask, 1) @ tmix.elastic_exp_matrix(mask, 0)
         ).numpy()
    live = mask == 1
    np.testing.assert_allclose(P[np.ix_(live, live)], np.full((4, 4), 0.25),
                               atol=1e-6)
    with pytest.raises(ValueError, match="pod_size"):
        tmix.elastic_hierarchical_matrix(ones, 3)
    with pytest.raises(ValueError, match="unknown topology"):
        tmix.elastic_matrix(ones, "torus")


def test_staleness_damping_and_edge_mask():
    s = np.array([0, 5, 0, 0, 0, 0, 0, 0], np.float32)
    ones = np.ones(8, np.float32)
    T = tmix.elastic_matrix(ones, "ring", staleness=s,
                            staleness_lambda=0.5).numpy()
    base = tmix.ring_matrix(8)
    assert tmix.is_doubly_stochastic(T)
    assert T[0, 1] < base[0, 1] and T[2, 1] < base[2, 1]
    assert T[4, 5] == pytest.approx(base[4, 5], abs=1e-6)
    T0 = tmix.elastic_matrix(ones, "ring", staleness=s,
                             staleness_lambda=0.0).numpy()
    np.testing.assert_allclose(T0, base, atol=1e-6)
    eo = np.ones((8, 8), np.float32)
    eo[0, 1] = eo[1, 0] = 0
    T = tmix.elastic_matrix(ones, "ring", edge_ok=eo).numpy()
    assert T[0, 1] == 0 and T[1, 0] == 0
    assert tmix.is_doubly_stochastic(T)


# ---------------------------------------------------------------------------
# The elastic mixer
# ---------------------------------------------------------------------------

def _leaves(L, seed):
    """f32 leaves of 37 and 2 x 60 elements a learner, and a bf16 one."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(L, 37)).astype(np.float32),
            "b": rng.normal(size=(L, 2, 60)).astype(np.float32),
            "w": rng.normal(size=(L, 6, 5)).astype(np.float32)}


def _jax_tree(p):
    return {"a": jnp.asarray(p["a"]), "b": jnp.asarray(p["b"]),
            "w": jnp.asarray(p["w"], jnp.bfloat16)}


def _torch_tree(p):
    return {"a": torch.from_numpy(p["a"]), "b": torch.from_numpy(p["b"]),
            "w": torch.from_numpy(p["w"]).to(torch.bfloat16)}


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_elastic_mixer_matches_jax(topology, wire):
    L = 8
    kw = dict(topology=topology, wire=wire, pod_size=4,
              staleness_lambda=0.3, bucket_bytes=64)
    jt, tt = jtr.Transport(**kw), ttr.Transport(**kw)
    jmixer, tmixer = jt.make_elastic_mixer(L), tt.make_elastic_mixer(L)
    rng = np.random.default_rng(
        3 * TOPOLOGIES.index(topology) + ("f32", "bf16", "int8").index(wire))
    for r in range(4):
        active = MASKS[r % len(MASKS)] if r else \
            (rng.random(L) > 0.3).astype(np.float32)
        if active.sum() == 0:
            active[0] = 1.0
        stale = rng.integers(0, 4, L).astype(np.int32)
        edge = _edge_mask(rng, L)
        corrupt = np.zeros(L, np.float32)
        p = _leaves(L, seed=r)
        want = jmixer(_jax_tree(p), jnp.int32(r), jnp.asarray(active),
                      jnp.asarray(stale), jnp.asarray(edge),
                      jnp.asarray(corrupt))
        got = tmixer(_torch_tree(p), r, active, stale, edge, corrupt)
        assert got["w"].dtype == torch.bfloat16
        for key in ("a", "b"):
            x = p[key].reshape(L, -1)
            jd = np.asarray(jtr._coded(jt, wire, jnp.asarray(x)))
            td = ttr._coded(tt, wire, torch.from_numpy(x)).numpy()
            assert jd.tobytes() == td.tobytes(), (r, key)
            w_ = np.asarray(want[key])
            err = np.abs(got[key].numpy() - w_).max() / np.abs(w_).max()
            assert err <= MATRIX_TOL, (r, key, err)
        # bf16 leaf: the same f32 mix, each side rounding it once
        w_ = np.asarray(want["w"].astype(jnp.float32))
        g_ = got["w"].float().numpy()
        assert (np.abs(g_ - w_) <= BF16_ULP * np.abs(w_) + 1e-30).all(), r
        for i in np.where(active == 0)[0]:          # the dead untouched
            for key in ("a", "b"):
                assert got[key][i].numpy().tobytes() == \
                    p[key][i].tobytes(), (r, key, i)
        assert tmixer.matrix(r, active, stale, edge).shape == (L, L)


def _corrupt_case(seed=0, scale=0.2):
    L = 8
    tt = ttr.Transport(topology="ring")
    rng = np.random.default_rng(3)
    p = {"a": torch.from_numpy(rng.normal(size=(L, 4000)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(L, 50)).astype(np.float32))}
    ones = np.ones(L, np.float32)
    corrupt = np.zeros(L, np.float32)
    corrupt[2] = scale
    args = (ones, np.zeros(L, np.int32), np.ones((L, L), np.float32))
    mixer = tt.make_elastic_mixer(L, fault_seed=seed, with_corruption=True)
    return L, tt, p, args, corrupt, mixer


def test_corruption_properties():
    L, tt, p, args, corrupt, mixer = _corrupt_case()
    clean = tt.make_elastic_mixer(L)(p, 7, *args, np.zeros(L, np.float32))
    got = mixer(p, 7, *args, corrupt)
    again = mixer(p, 7, *args, corrupt)
    other_step = mixer(p, 8, *args, corrupt)
    T = tt.make_elastic_mixer(L).matrix(7, *args).numpy()
    for key in ("a", "b"):
        # the corrupted learner's own replica is untouched, and so is every
        # learner that does not hear it
        for i in range(L):
            if i == 2 or T[i, 2] == 0:
                assert torch.equal(got[key][i], clean[key][i]), (key, i)
        assert torch.equal(got[key], again[key])          # deterministic
        assert not torch.equal(got[key], other_step[key])
    # a peer of learner 2 sees T[i, 2] times its noise: the noise RMS is
    # 0.2 · rms(payload), within 5 standard errors of a 4000-draw RMS
    x = p["a"][2].double()
    rms = float(torch.sqrt(torch.mean(x * x)))
    for i in (1, 3):
        dev = (got["a"][i].double() - clean["a"][i].double()) / T[i, 2]
        ratio = float(torch.sqrt(torch.mean(dev * dev))) / (0.2 * rms)
        assert abs(ratio - 1.0) <= 5 * np.sqrt(0.5 / 4000), ratio
    # corrupt = 0 everywhere is bit-equal to no corruption
    none = mixer(p, 7, *args, np.zeros(L, np.float32))
    for key in ("a", "b"):
        assert torch.equal(none[key], clean[key])
    # the draw depends on (seed, step, leaf, row) alone
    assert ttr.noise_seed(0, 7, 0, 2) == ttr.noise_seed(0, 7, 0, 2)
    assert len({ttr.noise_seed(s, k, i, r) for s in (0, 1) for k in (0, 1)
                for i in (0, 1) for r in (0, 1)}) == 16
    _, _, _, _, _, mixer1 = _corrupt_case(seed=1)
    assert not torch.equal(mixer1(p, 7, *args, corrupt)["a"], got["a"])


def test_topology_none_returns_params():
    tt = ttr.Transport(topology="none")
    p = {"a": torch.ones(4, 3)}
    L = 4
    out = tt.make_elastic_mixer(L)(p, 0, np.ones(L, np.float32),
                                   np.zeros(L, np.int32),
                                   np.ones((L, L), np.float32),
                                   np.zeros(L, np.float32))
    assert out is p


# ---------------------------------------------------------------------------
# Refusals, on both sides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["jax", "port"])
def test_elastic_refusals(side):
    tr, st = (jtr, JS) if side == "jax" else (ttr, TS)
    opt, sched = (jsgd(), jconstant(0.1)) if side == "jax" else \
        (sgd(), constant(0.1))
    with pytest.raises(ValueError, match="difference-coded"):
        tr.Transport(topology="ring", wire="topk").make_elastic_mixer(8)
    with pytest.raises(ValueError, match="pod_size"):
        tr.Transport(topology="hierarchical",
                     pod_size=3).make_elastic_mixer(8)
    with pytest.raises(ValueError, match="sc_psgd_replicated"):
        st.make_elastic_train_step(st.get_strategy("sc_psgd"),
                                   lambda p, b: 0.0, opt, sched,
                                   n_learners=1)
    with pytest.raises(ValueError, match="no active learners"):
        st.check_active(np.zeros(4))
    assert st.check_active(np.array([0, 1, 0, 1])) == 2
    with pytest.raises(ValueError, match="empty learner set"):
        st.split_learner_batch({"x": np.zeros((8, 2))}, 0)
