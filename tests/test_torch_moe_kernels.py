"""The plain version of the port's fused dense MoE (the K10 port's
``ref.moe_dense_plain``) and the CPU path of its wrapper
``kernels.moe_dense.moe_dense``, held against the JAX package on the CPU:
the Pallas kernel in interpret mode, ``repro.kernels.ref.moe_dense_ref``
and the reference model's dense branch (``repro.models.moe.moe_apply``).

Tolerances (docs/kernels.md): bf16 outputs at 2e-2 normalised by the
output's largest value; 3e-2 where the kernel's math is held against the
model branch, whose bf16 combine rounds the router weights (as
``tests/test_kernels.py`` holds the Pallas kernel against it).  The
Pallas kernel asserts T % tile_t == 0, so ragged T is held against
``moe_dense_ref`` alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.moe_dense import moe_dense as jax_moe_dense  # noqa: E402
from repro.kernels.ref import moe_dense_ref  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import moe_dense as MD  # noqa: E402
from repro_torch.kernels.ref import moe_dense_plain  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

BF16_TOL = 2e-2
MODEL_TOL = 3e-2


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _inputs(T, d, E, f, k, seed):
    """x, wi, wg, wo rounded to bf16 (weights at 1/sqrt(fan-in)) and the
    renormalised top-k router weights (T, E) f32, as numpy."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((T, d)))
    wi = _bf16(rng.standard_normal((E, d, f)) / np.sqrt(d))
    wg = _bf16(rng.standard_normal((E, d, f)) / np.sqrt(d))
    wo = _bf16(rng.standard_normal((E, f, d)) / np.sqrt(f))
    logits = rng.standard_normal((T, E))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :k]
    top = np.take_along_axis(probs, idx, -1)
    w = np.zeros((T, E), np.float32)
    np.put_along_axis(w, idx, top / top.sum(-1, keepdims=True), -1)
    return x, w, wi, wg, wo


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("T,d,E,f,k,tile", [
    (64, 32, 4, 16, 2, 32),
    (128, 64, 8, 32, 2, 64),
    (32, 128, 6, 64, 3, 32),
])
def test_plain_matches_jax_kernel_and_ref(T, d, E, f, k, tile, act):
    """The Pallas kernel keeps its products in f32; the oracle rounds each
    to bf16, as the plain version does."""
    x, w, wi, wg, wo = _inputs(T, d, E, f, k, seed=T + d + E)
    want_k = jax_moe_dense(*map(jnp.asarray, (x, w, wi, wg, wo)), act=act,
                           tile_t=tile, interpret=True)
    want_r = moe_dense_ref(*map(jnp.asarray, (x, w, wi, wg, wo)), act=act)
    got = moe_dense_plain(*map(_t, (x, w, wi, wg, wo)), act=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, d)
    assert _err(want_k, got) <= BF16_TOL
    assert _err(want_r, got) <= BF16_TOL


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("T", [1, 7, 77])
def test_plain_matches_ref_at_ragged_T(T, act):
    """Any T: the Pallas kernel refuses these (T % tile_t), the oracle and
    the port take them."""
    x, w, wi, wg, wo = _inputs(T, 64, 5, 32, 2, seed=T)
    want = moe_dense_ref(*map(jnp.asarray, (x, w, wi, wg, wo)), act=act)
    got = moe_dense_plain(*map(_t, (x, w, wi, wg, wo)), act=act)
    assert _err(want, got) <= BF16_TOL
    # a token's output does not depend on the tokens beside it
    one = moe_dense_plain(*map(_t, (x[:1], w[:1], wi, wg, wo)), act=act)
    assert _err(np.asarray(got[:1].float()), one) <= BF16_TOL


def test_plain_matches_the_model_dense_branch():
    """The reduced granite's dense branch (``moe_apply``, routing groups
    and a bf16 combine) against the plain version fed ``moe_apply``'s own
    router weights, on JAX-initialised weights."""
    cfg = jax_get_arch("granite-moe-3b-a800m").reduced()
    p = init_spec_tree(JM.moe_param_specs(cfg), jax.random.PRNGKey(1))
    rng = np.random.default_rng(60)
    x = _bf16(rng.standard_normal((2, 32, cfg.d_model)))
    y_model, _ = JM.moe_apply(cfg, p, jnp.asarray(x))
    m = cfg.moe
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        p["router"])
    top, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), m.top_k)
    top = top / top.sum(-1, keepdims=True)
    oh = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.float32)
    w_te = np.asarray(jnp.einsum("bsk,bske->bse", top, oh)).reshape(64, -1)
    tp = from_jax_params(jax.tree.map(np.asarray, p))
    got = moe_dense_plain(_t(x.reshape(64, -1)), _t(w_te), tp["wi"],
                          tp["wg"], tp["wo"], act=cfg.act)
    assert _err(np.asarray(y_model, np.float32).reshape(64, -1),
                got) <= MODEL_TOL


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    x, w, wi, wg, wo = map(_t, _inputs(9, 64, 4, 64, 2, seed=3))
    before = MD.launches
    got = MD.moe_dense(x, w, wi, wg, wo)
    assert MD.launches == before
    assert torch.equal(got, moe_dense_plain(x, w, wi, wg, wo))
    with pytest.raises(ValueError, match="act"):
        MD.moe_dense(x, w, wi, wg, wo, act="relu")
    with pytest.raises(ValueError, match="router_w"):
        MD.moe_dense(x, w[:, :3], wi, wg, wo)
    with pytest.raises(ValueError, match="do not match"):
        MD.moe_dense(x, w, wi, wg, wo[:, :32])


def test_kernel_shape_limits():
    """Clusters of f / 64 CTAs at prefill (at most 8; twice as many of half
    the columns at decode), each computing d / (f / 64) output columns, a
    multiple of 64 up to 192: granite's (1536, 512) and its reduced (256,
    128) are taken.  The work list's launch takes 1 to 1024 experts (the
    expert-group partials of the parent kernel are gone); items hold all
    of one expert's tokens up to T = 16, else 64 rows."""
    for d, f in ((1536, 512), (256, 128), (512, 256), (64, 64)):
        MD._check_kernel_shapes(d, f)
    for d, f in ((1536, 96), (1536, 1024), (1600, 512), (2048, 128)):
        with pytest.raises(ValueError):
            MD._check_kernel_shapes(d, f)
    MD._check_kernel_shapes(1536, 512, 40)
    MD._check_kernel_shapes(1536, 512, MD.MAX_EXPERTS)
    for E in (0, MD.MAX_EXPERTS + 1):
        with pytest.raises(ValueError, match="experts"):
            MD._check_kernel_shapes(1536, 512, E)
    assert [MD.item_rows(T) for T in (1, 8, 16, 17, 700)] == \
        [16, 16, 16, 64, 64]
    cfg = get_arch("granite-moe-3b-a800m")
    MD._check_kernel_shapes(cfg.d_model, cfg.moe.d_ff_expert)
    red = cfg.reduced()
    MD._check_kernel_shapes(red.d_model, red.moe.d_ff_expert)
