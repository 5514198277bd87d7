"""The port's spec trees, sharding rules, meshes, multihost scaffolding and
parameter counts held against the JAX package's, for every arch.

* ``SHAPE_REGISTRY`` equals the reference's.
* The spec trees (``param_specs``, ``cache_specs`` at ``decode_32k``,
  ``input_specs`` for each shape and mode) have the reference's paths,
  shapes, dtypes and logical axes.
* ``MeshRules.spec`` equals the reference's ``PartitionSpec`` entry for
  entry for every leaf (with and without the learner axis) on the (16,
  16) and (2, 16, 16) geometries (the duck-typed mesh of
  ``tests/test_sharding.py``), ``optimized()`` included; a hypothesis
  sweep over random dimensions and axes; ``local_shape`` divides each
  sharded dimension by its axes' size.
* ``count_params`` and ``count_active_params`` equal the reference's.
* ``launch.multihost``: the reference's three single-process cases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.analysis import params as JP  # noqa: E402
from repro.configs import ARCH_REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import SHAPE_REGISTRY as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.mesh import rules_for as jax_rules_for  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.sharding import MeshRules as JaxMeshRules  # noqa: E402
from repro.sharding import ParamSpec as JaxSpec  # noqa: E402
from repro.sharding import default_rules as jax_default_rules  # noqa: E402
from repro.sharding import multipod_rules as jax_multipod_rules  # noqa: E402
from repro_torch.analysis import params as TP  # noqa: E402
from repro_torch.configs import SHAPE_REGISTRY, get_arch  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.multihost import (host_batch_slice,  # noqa: E402
                                          initialize, make_global_batch)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import (MeshRules, default_rules,  # noqa: E402
                                  multipod_rules, spec_tree_bytes,
                                  spec_tree_shardings, spec_tree_to_fake)

ARCHS = sorted(JAX_REGISTRY)
MODES = ("train", "prefill", "decode")


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by MeshRules.spec."""

    def __init__(self, shape):
        self.shape = shape


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _jax_leaves(tree):
    out = {}
    for path, ps in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JaxSpec))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[key] = ps
    return out


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}/{k}" if pre else k))
        return out
    return {pre: tree}


def _trees(name):
    """[(label, jax spec tree, port spec tree)] of one arch: params, the
    decode cache at decode_32k, and the inputs of every shape and mode."""
    jm, tm = jax_build_model(jax_get_arch(name)), build_model(get_arch(name))
    out = [("params", jm.param_specs(), tm.param_specs())]
    if tm.cfg.supports_decode:
        out.append(("cache", jm.cache_specs(JAX_SHAPES["decode_32k"]),
                    tm.cache_specs(SHAPE_REGISTRY["decode_32k"])))
    for shape in JAX_SHAPES:
        for mode in MODES:
            if tm.cfg.family == "lstm" and mode != "train":
                continue
            out.append((f"inputs {shape} {mode}",
                        jm.input_specs(JAX_SHAPES[shape], mode),
                        tm.input_specs(SHAPE_REGISTRY[shape], mode)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch_trees(request):
    return request.param, _trees(request.param)


def test_shape_registry_equals_the_reference():
    assert sorted(SHAPE_REGISTRY) == sorted(JAX_SHAPES)
    for name, s in SHAPE_REGISTRY.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JAX_SHAPES[name])
        assert s.is_decode == JAX_SHAPES[name].is_decode


def test_spec_trees_equal_the_reference(arch_trees):
    name, trees = arch_trees
    for label, jt, tt in trees:
        a, b = _jax_leaves(jt), _leaves(tt)
        assert sorted(a) == sorted(b), (name, label)
        for k in a:
            assert (tuple(b[k].shape), b[k].dtype, tuple(b[k].axes)) == (
                tuple(a[k].shape), a[k].dtype, tuple(a[k].axes)), (
                    name, label, k)


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("multi", [False, True])
def test_mesh_rules_equal_the_reference(arch_trees, multi, opt):
    name, trees = arch_trees
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    if opt:
        jcfg, tcfg = jcfg.optimized(), tcfg.optimized()
    mesh = MULTI if multi else POD
    jr = jax_rules_for(jcfg, mesh, multi_pod=multi)
    tr = TM.rules_for(tcfg, mesh, multi_pod=multi)
    assert tr.rules == jr.rules
    for lead in ((), ((16, "learner"),)):
        for label, jt, tt in trees:
            a, b = _jax_leaves(jt), _leaves(tt)
            for k, ps in a.items():
                shape = tuple(s for s, _ in lead) + tuple(ps.shape)
                axes = tuple(x for _, x in lead) + tuple(ps.axes)
                want = tuple(jr.spec(shape, axes))
                got = tr.spec(shape, axes)
                want = want + (None,) * (len(shape) - len(want))
                assert got == want, (name, label, k, lead)
            specs = _leaves(spec_tree_shardings(tt, tr, lead))
            for k, ps in b.items():
                assert specs[k] == tr.spec(
                    tuple(s for s, _ in lead) + tuple(ps.shape),
                    tuple(x for _, x in lead) + tuple(ps.axes))


def test_parameter_counts_equal_the_reference(arch_trees):
    name, trees = arch_trees
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    jt, tt = trees[0][1], trees[0][2]
    assert TP.count_params(tt) == JP.count_params(jt)
    assert TP.count_active_params(tcfg, tt) == \
        JP.count_active_params(jcfg, jt)


AXES = sorted(k for k in default_rules() if k is not None) + [None]


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([1, 2, 3, 8, 16, 32, 40, 64, 256,
                                           512, 1024, 4096]),
                          st.sampled_from(AXES)), min_size=1, max_size=5),
       st.booleans(), st.booleans(), st.sampled_from(["", "data"]))
def test_spec_sweep_equals_the_reference(dims, multi, fsdp, expert_axis):
    mesh = MULTI if multi else POD
    shape = tuple(n for n, _ in dims)
    axes = tuple(a for _, a in dims)
    kw = dict(fsdp=fsdp, expert_axis=expert_axis)
    jr = JaxMeshRules(mesh, (jax_multipod_rules if multi
                             else jax_default_rules)(**kw))
    tr = MeshRules(mesh, (multipod_rules if multi else default_rules)(**kw))
    want = tuple(jr.spec(shape, axes))
    want = want + (None,) * (len(shape) - len(want))
    got = tr.spec(shape, axes)
    assert got == want
    local = tr.local_shape(shape, axes)
    for n, m, entry in zip(shape, local, got):
        group = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        size = int(np.prod([mesh.shape[a] for a in group])) if group else 1
        assert n % size == 0 and m == n // size


def test_meshes_and_the_bytes_of_a_tree():
    pod, multi = TM.make_production_mesh(), \
        TM.make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and pod.abstract and multi.abstract
    local = TM.make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1} and not local.abstract
    with TM.use_mesh(pod) as m:
        assert m is pod
    cfg = get_arch("phi3-medium-14b")
    seq = dataclasses.replace(cfg, attn_sharding="seq")
    assert TM.rules_for(seq, pod).rules["head_dim"] == ("model",)
    assert TM.rules_for(cfg, pod).rules["head_dim"] == ()
    specs = build_model(get_arch("smollm-360m").reduced()).param_specs()
    rules = TM.rules_for(get_arch("smollm-360m"), pod)
    whole = spec_tree_bytes(specs)
    assert whole == sum(t.numel() * t.element_size() for t in
                        _leaves(spec_tree_to_fake(specs)).values())
    per_dev = spec_tree_bytes(specs, rules)
    assert 0 < per_dev < whole
    assert per_dev == sum(
        int(np.prod(rules.local_shape(ps.shape, ps.axes))) *
        (4 if ps.dtype == "float32" else 2) for ps in _leaves(specs).values())
    fake = _leaves(spec_tree_to_fake(specs, ((2, "learner"),)))
    assert all(t.device.type == "meta" and t.shape[0] == 2
               for t in fake.values())


def test_initialize_noop_single_process():
    assert initialize() is False


def test_host_batch_slice_single():
    assert host_batch_slice(32) == (0, 32)


def test_make_global_batch_single_process():
    cfg = get_arch("smollm-360m").reduced()
    mesh = TM.make_local_mesh(device="cpu")
    rules = TM.rules_for(cfg, mesh)
    batch = {"tokens": np.arange(32, dtype=np.int32).reshape(4, 8)}
    out = make_global_batch(batch, mesh, rules, {"tokens": ("batch", "seq")})
    assert out["tokens"].shape == (4, 8)
    assert out["tokens"].dtype == torch.int32
    assert np.array_equal(out["tokens"].numpy(), batch["tokens"])
