"""Training the port's decoder-only families (``repro_torch.models.api.
Model.loss_fn`` and the train step) held against the JAX package on the
CPU, at reduced width over 2 learners.

Each learner gets weights of its own, drawn with numpy on the port's
specs (``test_torch_encdec.numpy_params``: the per-layer lecun fan-in)
and handed to both packages; the batch is the port's synthetic data split
over the learners.  The port's per-learner losses and every gradient leaf
(one pass over the learner-stacked tree) are held against
``jax.vmap(jax.value_and_grad(Model.loss_fn))``, the losses relative and
each gradient leaf normalised by the reference leaf's max-abs, at the
family's forward-test tolerance: 2e-2 for dense and vlm (the bf16 output
tolerance of their forward tests) and 3e-2 for moe (the dense-MoE
branch's: the port's plain version combines in f32 where the reference
rounds the router weights to bf16).

The moe families are held end to end on their losses alone: their
gradients are not continuous in the weights (a top-k choice that flips
on a near-tie, or a token a capacity router drops, moves a whole
expert's contribution), and XLA's and PyTorch's bf16 roundings of the
activations feeding a router differ by an ulp, which flips such choices
(measured over four seeds: granite's worst leaf 0.016-0.047 from the
reference, llama4-scout's top-1 0.015-0.28, while both losses agree
within 5e-4).  Their MoE blocks' gradients (the learner path: router,
softmax and top-k per learner, the aux loss per learner, the dense
router's learner-folded call, the capacity router's per-learner experts
and the shared expert) are held on equal activations in both packages,
layer by layer as ``test_torch_moe_model`` holds llama4-scout's forward,
at 3e-2.  The routers keep the reference's scale (its stacked lecun
fan-in, the layer count).

Then three ad_psgd steps of reduced smollm-360m (2 microbatches) through
both packages' ``make_train_step`` from the same state: losses and the
final parameters at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import get_optimizer as jax_optimizer  # noqa: E402
from repro.optim.schedules import paper_recipe as jax_recipe  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedules import paper_recipe  # noqa: E402
from repro_torch.params import from_jax_params, from_jax_state  # noqa: E402
from test_torch_encdec import numpy_params  # noqa: E402

L = 2
TOL = {"dense": 2e-2, "vlm": 2e-2, "moe": 3e-2}


def learner_params(tm, seed, router_sharp=False):
    """L learners' numpy weights, each drawn on its own seed, stacked on a
    leading axis; with ``router_sharp`` the moe routers scaled to the
    reference's 1/sqrt(n_layers)."""
    trees = []
    for i in range(L):
        npp = numpy_params(tm.param_specs(), seed + i)
        if router_sharp:
            moe = npp["layers"]["moe"]
            d = moe["router"].shape[1]
            moe["router"] = (moe["router"] * np.float32(
                np.sqrt(d / tm.cfg.n_layers))).astype(np.float32)
        trees.append(npp)
    return jax.tree.map(lambda *a: np.stack(a), *trees)


def learner_batch(cfg, seq_len, per_learner, seed=0):
    """One batch of the port's dataset for ``cfg``, split (L, B/L, ...)."""
    b = make_dataset(cfg, seq_len=seq_len, batch=L * per_learner,
                     seed=seed).batch_at(0)
    return {k: v.reshape(L, per_learner, *v.shape[1:]) for k, v in b.items()}


def _at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def leaf_errors(jgrads, tgrads):
    """{path: max |port - ref| / max |ref|} over every gradient leaf.  An
    attention's key bias ``bk`` has a zero gradient in exact arithmetic
    (it shifts each query's scores by a constant), so both packages'
    values are rounding noise (~1e-6): it is normalised by the max-abs of
    its sibling query bias ``bq`` instead."""
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    out = {}
    for path, want in jax.tree_util.tree_flatten_with_path(ref)[0]:
        got = _at(tgrads, path)
        assert tuple(got.shape) == want.shape, path
        scale = want
        if getattr(path[-1], "key", None) == "bk":
            scale = _at(ref, path[:-1])["bq"]
        out[jax.tree_util.keystr(path)] = float(
            np.abs(got.float().numpy() - want).max()
            / (np.abs(scale).max() + 1e-12))
    return out


def hold_loss_and_grads(name, seq_len, tol, *, per_learner=2,
                        router_sharp=False, seed=0, loss_tol=None):
    """The port's Model.loss_fn and its gradients against the JAX
    package's vmapped value_and_grad on the same weights and batch."""
    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    npp = learner_params(tm, seed, router_sharp)
    batch = learner_batch(tcfg, seq_len, per_learner, seed)
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(jm.loss_fn)))(
        jax.tree.map(jnp.asarray, npp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = TS._value_and_grad(
        tm.loss_fn, from_jax_params(npp),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    want = np.asarray(jloss, np.float32)
    assert tloss.shape == (L,) and want.shape == (L,)
    loss_err = float(np.abs(tloss.numpy() - want).max() / np.abs(want).max())
    errs = leaf_errors(jgrads, tgrads)
    worst = max(errs, key=errs.get)
    assert loss_err <= (loss_tol or tol), (name, loss_err, want, tloss)
    assert errs[worst] <= tol, (name, worst, errs[worst])
    return tloss, tgrads


@pytest.mark.parametrize("name,family,seq_len", [
    ("smollm-360m", "dense", 32),
    ("internvl2-2b", "vlm", 40),         # 10 patch positions, 30 text tokens
])
def test_loss_and_grads_match_jax(name, family, seq_len):
    assert get_arch(name).family == family
    hold_loss_and_grads(name, seq_len, TOL[family])


def jax_and_port_losses(name, seq_len, seed=0):
    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    npp = learner_params(tm, seed, router_sharp=True)
    batch = learner_batch(tcfg, seq_len, 2, seed)
    want = jax.vmap(jm.loss_fn)(
        jax.tree.map(jnp.asarray, npp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.loss_fn(from_jax_params(npp),
                     {k: torch.as_tensor(v) for k, v in batch.items()})
    return np.asarray(want, np.float32), got.detach().numpy()


@pytest.mark.parametrize("name,seq_len", [
    ("granite-moe-3b-a800m", 32),        # dense router, top-2 of 4
    ("llama4-scout-17b-a16e", 80),       # capacity router, window 64
])
def test_moe_loss_matches_jax(name, seq_len):
    """The per-learner losses (cross entropy plus the weighted aux loss)
    end to end."""
    want, got = jax_and_port_losses(name, seq_len)
    assert got.shape == (L,)
    assert np.abs(got - want).max() <= TOL["moe"] * np.abs(want).max()


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("layer", [0, 1])
def test_moe_block_grads_match_jax(name, layer):
    """Each layer's MoE block over 2 learners on the same bf16
    activations: the port's learner path (``moe_apply`` on x (L, B, S,
    d)) against ``jax.vmap`` of the reference's ``moe_apply``; the
    gradients of sum(y^2) + aux to x and every MoE weight at 3e-2."""
    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    tm = build_model(tcfg)
    npp = jax.tree.map(lambda a: a[:, layer],
                       learner_params(tm, 0, router_sharp=True)
                       ["layers"]["moe"])
    rng = np.random.default_rng(layer)
    x = np.asarray(jnp.asarray(rng.standard_normal(
        (L, 2, 40, tcfg.d_model)), jnp.bfloat16))

    def jloss(p, xx):
        y, aux = JM.moe_apply(jcfg, p, xx)
        return jnp.sum(jnp.square(y.astype(jnp.float32))) + aux

    jgx, jgp = jax.vmap(jax.grad(lambda xx, p: jloss(p, xx), argnums=(0, 1)))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, npp))
    tp = {k: v.requires_grad_() for k, v in from_jax_params(npp).items()}
    tx = from_jax_params({"x": x})["x"].requires_grad_()
    y, aux = TM.moe_apply(tcfg, tp, tx)
    assert aux.shape == (L,)
    (y.float().square().sum(dim=(1, 2, 3)) + aux).sum().backward()
    errs = leaf_errors({"x": jgx, **jgp}, {"x": tx.grad, **{
        k: v.grad for k, v in tp.items()}})
    assert max(errs.values()) <= TOL["moe"], errs


def test_learners_are_independent():
    """Learner 1's loss and gradients do not depend on learner 0's
    weights: the learner-stacked pass computes each learner's own."""
    tcfg = get_arch("granite-moe-3b-a800m").reduced()
    tm = build_model(tcfg)
    npp = learner_params(tm, 0, router_sharp=True)
    batch = {k: torch.as_tensor(v)
             for k, v in learner_batch(tcfg, 32, 2).items()}
    loss, grads = TS._value_and_grad(tm.loss_fn, from_jax_params(npp), batch)
    other = jax.tree.map(lambda a: a.copy(), npp)
    other["layers"]["moe"]["wi"][0] = other["layers"]["moe"]["wi"][1]
    other["embed"][0] = 0
    loss2, grads2 = TS._value_and_grad(tm.loss_fn, from_jax_params(other),
                                       batch)
    assert float(loss[1]) == float(loss2[1])
    assert float(loss[0]) != float(loss2[0])
    for a, b in zip(TS._leaves(grads), TS._leaves(grads2)):
        assert torch.equal(a[1], b[1])


def test_one_model_loss_is_its_learner_row():
    """Params and a batch without a learner axis give the scalar loss of
    that model: the learner row of the stacked call."""
    tcfg = get_arch("smollm-360m").reduced()
    tm = build_model(tcfg)
    npp = learner_params(tm, 0)
    tp = from_jax_params(npp)
    batch = {k: torch.as_tensor(v)
             for k, v in learner_batch(tcfg, 16, 2).items()}
    stacked = tm.loss_fn(tp, batch)
    one = tm.loss_fn({k: TS.tree_map(lambda w: w[1], v)
                      if isinstance(v, dict) else v[1]
                      for k, v in tp.items()},
                     {k: v[1] for k, v in batch.items()})
    assert one.shape == () and abs(float(one) - float(stacked[1])) <= 1e-6


def test_ad_psgd_trajectory_matches_jax():
    """Three ad_psgd steps (2 microbatches) of reduced smollm-360m from the
    same state: each step's loss and the final parameters within 2e-2."""
    name, tol = "smollm-360m", 2e-2
    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    params = jax.tree.map(jnp.asarray, learner_params(tm, 0))
    jstrat = JS.get_strategy("ad_psgd")
    jstate = JS.init_state(jstrat, params, jax_optimizer("sgd"))
    jstep = jax.jit(JS.make_train_step(
        jstrat, jm.loss_fn, jax_optimizer("sgd"), jax_recipe(3, 0.05, 0.2),
        n_learners=L, microbatches=2))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    tstep = TS.make_train_step(
        TS.get_strategy("ad_psgd"), tm.loss_fn, get_optimizer("sgd"),
        paper_recipe(3, 0.05, 0.2), n_learners=L, microbatches=2)
    ds = make_dataset(tcfg, seq_len=24, batch=8, seed=0)
    for k in range(3):
        batch = ds.batch_at(k)
        jstate, jmet = jstep(jstate, {key: jnp.asarray(v)
                                      for key, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= tol * abs(want), k
    errs = leaf_errors(jstate["params"], tstate["params"])
    assert max(errs.values()) <= tol, max(errs.items(), key=lambda e: e[1])
