"""The port's training loss, optimizers, schedules and mixing held against
the JAX package on the CPU.

``loss_train`` value and gradients are compared at the bf16 gradient
tolerance 2e-2 normalised (docs/kernels.md §Oracle tolerances); the
optimizers, schedules and mixers compute in f32 op for op as the
reference does, so they are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.transport import Transport  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

BF16_TOL = 2e-2


def _norm_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-12)


def _tree(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _bits(a):
    return np.asarray(a).astype(np.float32).tobytes()


def _cfgs():
    return (jax_get_arch("swb2000-blstm").reduced(),
            get_arch("swb2000-blstm").reduced())


def _batch(cfg, B, T, lengths, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"features": rng.normal(size=(B, T, cfg.input_dim)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, size=(B, T)).astype(
                 np.int32)}
    if lengths is not None:
        batch["lengths"] = np.asarray(lengths, np.int32)
    return batch


def _requires_grad(tree, leaves):
    if isinstance(tree, dict):
        return {k: _requires_grad(v, leaves) for k, v in tree.items()}
    t = tree.detach().requires_grad_(True)
    leaves.append(t)
    return t


@pytest.mark.parametrize("lengths", [None, (6, 3, 1)])
def test_loss_train_matches_jax(lengths):
    """Value and every gradient of ``loss_train`` against
    ``jax.value_and_grad(loss_train, kernel_impl="pallas")``."""
    jcfg, tcfg = _cfgs()
    params = init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0))
    batch = _batch(jcfg, 3, 6, lengths)
    want, grads = jax.value_and_grad(lambda p: jlstm.loss_train(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
        kernel_impl="pallas"))(params)
    leaves = []
    tparams = _requires_grad(_tree(params), leaves)
    got = tlstm.loss_train(tcfg, tparams, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                           device="cpu")
    got.backward()
    assert got.dim() == 0
    assert abs(float(got.detach()) - float(want)) <= BF16_TOL * abs(float(want))
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        t = tparams
        for p in path:
            t = t[p.key]
        assert t.grad.dtype == t.dtype, path
        assert _norm_err(t.grad.float().numpy(), leaf) <= BF16_TOL, path


def test_loss_train_per_learner():
    """Stacked learners: one loss per learner, each the single model's."""
    jcfg, tcfg = _cfgs()
    params = _tree(init_spec_tree(jlstm.param_specs(jcfg),
                                  jax.random.PRNGKey(0)))
    stacked = TS.stack_for_learners(params, 2)
    stacked["softmax_b"] = stacked["softmax_b"] + torch.tensor([[0.], [1.]])
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(jcfg, 4, 5, (5, 2, 4, 1)).items()}
    lb = TS.split_learner_batch(batch, 2)
    with torch.no_grad():
        got = tlstm.loss_train(tcfg, stacked, lb, device="cpu")
        assert got.shape == (2,)
        for l in range(2):
            one = {k: v[l] for k, v in lb.items()}
            p1 = TS.average_learners(_slice(stacked, l))
            want = tlstm.loss_train(tcfg, p1, one, device="cpu")
            assert torch.allclose(got[l], want, rtol=1e-6, atol=0)


def _slice(tree, l):
    if isinstance(tree, dict):
        return {k: _slice(v, l) for k, v in tree.items()}
    return tree[l:l + 1]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(masked, z_loss):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    mask = (np.arange(5)[None] < np.asarray([5, 2, 0])[:, None]) \
        if masked else None
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 z_loss, None if mask is None
                                 else jnp.asarray(mask))
    got = tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), z_loss,
                                None if mask is None
                                else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("lead", [None, 3])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_bit_equal(name, lead):
    """Three updates on the same numpy inputs, one model or stacked
    learners (the reference ``jax.vmap``s the update over them)."""
    rng = np.random.default_rng(0)
    shape = () if lead is None else (lead,)

    def tree():
        return {"w": jnp.asarray(rng.normal(size=shape + (5, 7)),
                                 jnp.bfloat16),
                "b": jnp.asarray(rng.normal(size=shape + (7,)), jnp.float32)}

    p, g = tree(), tree()
    jo, to = jopt.get_optimizer(name), topt.get_optimizer(name)
    js = jax.vmap(jo.init)(p) if lead else jo.init(p)
    tp, tg = _tree(p), _tree(g)
    ts = to.init(tp, lead)
    for k in range(3):
        lr = jsched.paper_recipe(3, 0.05, 0.2)(jnp.int32(k))
        if lead:
            p, js = jax.vmap(jo.update, in_axes=(0, 0, 0, None))(g, js, p, lr)
        else:
            p, js = jo.update(g, js, p, lr)
        tp, ts = to.update(tg, ts, tp, tsched.paper_recipe(3, 0.05, 0.2)(k))
    for key in ("w", "b"):
        assert tp[key].dtype == _tree(p)[key].dtype
        assert _bits(p[key]) == tp[key].float().numpy().tobytes(), key


@pytest.mark.parametrize("make", [
    lambda m: m.paper_recipe(3, 0.05, 0.2),
    lambda m: m.paper_recipe(1),
    lambda m: m.warmup_then_anneal(0.1, 0.5, 100, 10_000, 1 / np.sqrt(2)),
])
def test_schedules_bit_equal(make):
    js, ts = make(jsched), make(tsched)
    for step in list(range(0, 60)) + [99, 100, 101, 10_099, 10_100, 25_000]:
        want = np.float32(js(jnp.int32(step)))
        got = ts(step)
        assert got.dtype == torch.float32
        assert want.tobytes() == got.numpy().tobytes(), step


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["mix_ring", "mix_uniform"])
def test_mixers_bit_equal(name, L):
    rng = np.random.default_rng(L)
    p = {"w": jnp.asarray(rng.normal(size=(L, 9, 5)), jnp.bfloat16),
         "b": jnp.asarray(rng.normal(size=(L, 13)), jnp.float32)}
    want = getattr(jmix, name)(p)
    got = getattr(tmix, name)(_tree(p))
    for key in ("w", "b"):
        assert got[key].dtype == _tree(p)[key].dtype
        assert _bits(want[key]) == got[key].float().numpy().tobytes(), key


@pytest.mark.parametrize("L", [1, 2, 3, 5, 16])
def test_mixing_matrices(L):
    for name in ("ring_matrix", "uniform_matrix"):
        T = getattr(tmix, name)(L)
        np.testing.assert_array_equal(T, getattr(jmix, name)(L))
        assert tmix.is_doubly_stochastic(T)
    assert not tmix.is_doubly_stochastic(np.eye(L) * 2)


@pytest.mark.parametrize("topology", ["ring", "uniform"])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_transport_wire_bytes_and_mixer(topology, L):
    rng = np.random.default_rng(L)
    p = {"w": jnp.asarray(rng.normal(size=(L, 6, 4)), jnp.bfloat16),
         "b": jnp.asarray(rng.normal(size=(L, 3)), jnp.float32)}
    jt = jtr.Transport(topology=topology)
    tt = Transport(topology=topology)
    assert tt.wire_bytes(_tree(p)) == jt.wire_bytes(p)
    want, _ = jt.make_mixer(L)(p, 0, {})
    got, comm = tt.make_mixer(L)(_tree(p), 0, {})
    assert comm == {}
    for key in ("w", "b"):
        assert _bits(want[key]) == got[key].float().numpy().tobytes()


@pytest.mark.parametrize("kw", [
    dict(topology="exp"),
    dict(topology="hierarchical", pod_size=2),
    dict(wire="int8"),
    dict(bucket_bytes=64),
], ids=["exp", "hierarchical", "int8", "bucketed"])
def test_transport_once_refused_now_matches_jax(kw):
    """The four configurations the f32-only transport refused before the
    wire codecs and topologies were ported: wire bytes equal and the mixed
    replicas bit for bit (the full grid is tests/test_torch_comm.py)."""
    L = 4
    rng = np.random.default_rng(7)
    p = {"w": jnp.asarray(rng.normal(size=(L, 6, 4)), jnp.bfloat16),
         "b": jnp.asarray(rng.normal(size=(L, 30)), jnp.float32)}
    jt, tt = jtr.Transport(**kw), Transport(**kw)
    assert tt.wire_bytes(_tree(p)) == jt.wire_bytes(p)
    for step in range(3):
        want, _ = jt.make_mixer(L)(p, jnp.int32(step), {})
        got, _ = tt.make_mixer(L)(_tree(p), step, {})
        for key in ("w", "b"):
            assert _bits(want[key]) == got[key].float().numpy().tobytes()


@pytest.mark.parametrize("kw,err", [
    (dict(topology="torus"), ValueError),
    (dict(wire="fp4"), ValueError),
    (dict(intra_wire="topk"), ValueError),
    (dict(pod_size=0), ValueError),
    (dict(topk_frac=0.0), ValueError),
    (dict(gossip_gamma=1.5), ValueError),
    (dict(staleness_lambda=-1.0), ValueError),
])
def test_transport_rejects_what_is_not_ported(kw, err):
    """What the reference refuses, the port refuses with the same error,
    ``make_elastic_mixer``'s refusal of a difference-coded wire
    included."""
    with pytest.raises(err):
        jtr.Transport(**kw)
    with pytest.raises(err):
        Transport(**kw)
    for make in (jtr.Transport, Transport):
        with pytest.raises(ValueError, match="difference-coded"):
            make(wire="topk").make_elastic_mixer(4)
    with pytest.raises(ValueError, match="pod_size"):
        Transport(topology="hierarchical", pod_size=3).make_mixer(4)
    with pytest.raises(ValueError, match="power-of-2"):
        Transport(topology="exp").make_mixer(6)


def test_strategy_rows_mirror_jax():
    from repro.core import strategies as JS

    assert set(TS.STRATEGIES) == set(JS.STRATEGIES)
    assert len(TS.STRATEGIES) == 9
    for name, row in TS.STRATEGIES.items():
        ref = JS.STRATEGIES[name]
        for field in ("topology", "wire", "stale", "replicated",
                      "block_size", "block_momentum", "block_lr"):
            assert getattr(row, field) == getattr(ref, field), (name, field)
        assert TS.get_strategy(name) is row
        assert TS.default_transport(row) == Transport(
            topology=ref.topology, wire=ref.wire)


@pytest.mark.parametrize("L", [1, 3])
def test_consensus_distance_matches_jax(L):
    from repro.core import strategies as JS

    rng = np.random.default_rng(L)
    p = {"w": jnp.asarray(rng.normal(size=(L, 9, 5)), jnp.bfloat16),
         "b": jnp.asarray(rng.normal(size=(L, 13)), jnp.float32)}
    want = float(JS.consensus_distance(p))
    got = float(TS.consensus_distance(_tree(p)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_split_learner_batch_names_the_key():
    batch = {"features": torch.zeros(6, 2, 3), "labels": torch.zeros(6, 2)}
    out = TS.split_learner_batch(batch, 3)
    assert out["features"].shape == (3, 2, 2, 3)
    with pytest.raises(ValueError, match="features"):
        TS.split_learner_batch(batch, 4)
