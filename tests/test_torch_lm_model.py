"""The port's dense decoder (``repro_torch.models.{common,ffn,attention,
transformer,api}``) held against the JAX package on the CPU at the
reduced ``smollm-360m`` width (2 layers, d 256, 4 heads over 2 KV heads,
head_dim 64, vocab 512), with the JAX weights carried over through
``from_jax_params``.

Prefill and decode are compared teacher-forced: both frameworks are fed
the JAX run's tokens, and the logits agree at the bf16 tolerance (2e-2,
normalised).  Greedy tokens are not compared across frameworks, since
they may flip on a near-tie.  The JAX decode runs its Pallas
decode-attention kernels in interpret mode: like the port's kernels they
keep scores in f32, while the jnp path rounds scores to bf16 — at this
init (the reference's lecun fan-in of a layer-stacked weight is the
layer count, so weights have scale 1/sqrt(2)) scores reach ~100 and that
rounding alone moves the logits by ~0.1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.sharding import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import ffn as TF_  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import ParamSpec, from_jax_params, init_params  # noqa: E402

BF16_TOL = 2e-2
F32_TOL = 1e-5
PROMPT, STEPS, CACHE = 11, 6, 32


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("smollm-360m").reduced()
    tcfg = get_arch("smollm-360m").reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = init_spec_tree(jm.param_specs(), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos,
                                                     kernel_impl="pallas"))
    jdec_paged = jax.jit(
        lambda p, c, t, pos, tbl: jm.decode_fn(p, c, t, pos,
                                               kernel_impl="pallas",
                                               page_table=tbl, page_size=4))
    return jcfg, tcfg, jm, tm, jp, tp, jdec, jdec_paged


@pytest.fixture(scope="module")
def prompts(models):
    jcfg = models[0]
    rng = np.random.default_rng(0)
    return rng.integers(0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirrors_jax_fields(reduced):
    """Every field the port carries equals the reference's, except the
    citation: the reference names SmolLM-135M for a 360M-dim config."""
    jcfg, tcfg = jax_get_arch("smollm-360m"), get_arch("smollm-360m")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        if f.name != "citation":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert "SmolLM-360M" in tcfg.citation
    assert tcfg.supports_decode and not get_arch(
        "swb2000-blstm").supports_decode
    if reduced:
        assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.head_dim) == (2, 64)
    else:
        assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.head_dim) == (3, 64)


def _shapes(tree, leaf_type):
    if isinstance(tree, dict):
        return {k: _shapes(v, leaf_type) for k, v in tree.items()}
    assert isinstance(tree, leaf_type)
    return (tuple(tree.shape), tree.dtype, tree.init)


def _jax_init(ps):
    """The reference's init recipe with a stacked lecun weight's fan-in
    taken per layer (shape[1]), as the port draws it: the reference takes
    it from the layer axis (ROADMAP queue 3)."""
    if ps.init == "lecun" and ps.axes[0] == "layers":
        return (tuple(ps.shape), ps.dtype, "normal",
                float(1.0 / np.sqrt(ps.shape[1])))
    return (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale)


def test_param_specs_match_jax(models):
    jcfg, tcfg, jm, tm = models[:4]
    want = jax.tree.map(_jax_init, jm.param_specs(),
                        is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = jax.tree.map(
        lambda ps: (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale),
        tm.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    assert got == want
    jc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype, ps.init),
                      jm.page_specs(12, 4),
                      is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = _shapes(tm.page_specs(12, 4), ParamSpec)
    assert jax.tree.map(lambda x: x[:2], jc,
                        is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.map(lambda x: x[:2], got,
                     is_leaf=lambda x: isinstance(x, tuple))


def test_init_params_ones_and_windows(models):
    tcfg, tm = models[1], models[3]
    p = init_params(tm.param_specs(), seed=3, device="cpu")
    assert torch.equal(p["layers"]["ln1"]["scale"],
                       torch.ones(tcfg.n_layers, tcfg.d_model))
    wq = p["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    # lecun at the per-layer fan-in d, not at the layer count
    assert abs(float(wq.float().std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    w = TT.layer_windows(tcfg, 64)
    assert w.dtype == np.int32 and (w == TT.GLOBAL_WINDOW).all()
    lc = TT.layer_windows(tcfg, 64, long_context=True)
    assert (lc == tcfg.window_for_long).all()


def test_other_families_raise():
    """The decoder-only stack refuses the encdec family, which
    ``models/encdec.py`` carries and ``build_model`` routes there; a vlm
    config builds the dense tree."""
    cfg = get_arch("smollm-360m").reduced()
    with pytest.raises(NotImplementedError, match="encdec.py"):
        TT.param_specs(dataclasses.replace(cfg, family="encdec"))
    vlm = build_model(dataclasses.replace(cfg, family="vlm")).param_specs()
    assert vlm == build_model(cfg).param_specs()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(48).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(48).astype(np.float32)
    want = JC.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = TC.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    assert _err(want, got) <= F32_TOL
    want = JC.rmsnorm(jnp.asarray(x), jnp.asarray(p["scale"]))
    got = TC.rmsnorm(torch.from_numpy(x), torch.from_numpy(p["scale"]))
    assert _err(want, got) <= F32_TOL


def test_rope_and_gelu_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(100, 107)[None, :].repeat(2, 0).astype(np.int32)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    assert _err(want, got) <= F32_TOL
    np.testing.assert_array_equal(TC.rope_freqs(16, 500.0),
                                  JC.rope_freqs(16, 500.0))
    assert _err(JC.gelu(jnp.asarray(x)),
                TC.gelu(torch.from_numpy(x))) <= F32_TOL


@pytest.mark.parametrize("act,use_bias", [("swiglu", False), ("gelu", True)])
def test_ffn_matches_jax(act, use_bias):
    jcfg = dataclasses.replace(jax_get_arch("smollm-360m").reduced(),
                               act=act, use_bias=use_bias, d_ff=64,
                               d_model=32, param_dtype="float32")
    tcfg = dataclasses.replace(get_arch("smollm-360m").reduced(), act=act,
                               use_bias=use_bias, d_ff=64, d_model=32,
                               param_dtype="float32")
    jp = init_spec_tree(JF.ffn_param_specs(jcfg), jax.random.PRNGKey(4))
    if use_bias:
        jp = dict(jp, bi=jnp.full((64,), 0.1), bo=jnp.full((32,), -0.2))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    assert set(tp) == set(TF_.ffn_param_specs(tcfg))
    x = np.random.default_rng(5).standard_normal((2, 3, 32)).astype(
        np.float32)
    want = JF.ffn_apply(jcfg, jp, jnp.asarray(x))
    got = TF_.ffn_apply(tcfg, tp, torch.from_numpy(x))
    assert _err(want, got) <= F32_TOL


# ---------------------------------------------------------------------------
# prefill and teacher-forced decode vs JAX
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(models, prompts):
    _, _, jm, tm, jp, tp = models[:6]
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(prompts)},
                           cache_len=CACHE)
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                           cache_len=CACHE)
    assert tuple(tl.shape) == tuple(jl.shape) and tl.dtype == torch.bfloat16
    assert _err(jl, tl) <= BF16_TOL
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
        assert _err(jc["attn"][name], tc["attn"][name]) <= BF16_TOL
        assert not tc["attn"][name][:, :, PROMPT:].any()


def _greedy(logits):
    return np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]


def test_decode_teacher_forced_matches_jax(models, prompts):
    _, _, jm, tm, jp, tp, jdec, _ = models
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(prompts)},
                           cache_len=CACHE)
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_len=CACHE)
    tok = _greedy(jl)
    for step in range(STEPS):
        pos = PROMPT + step
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), pos)
        assert _err(jl, tl) <= BF16_TOL, step
        for name in ("k", "v"):
            assert _err(jc["attn"][name], tc["attn"][name]) <= BF16_TOL
        tok = _greedy(jl)          # both fed the JAX run's tokens


def test_paged_decode_teacher_forced_matches_jax(models, prompts):
    """The paged layout: a shuffled 24-page pool of 4-position pages, the
    prefill cache written into each request's pages, one decode per step
    through the paged kernels of both packages."""
    jcfg, tcfg, jm, tm, jp, tp, _, jdec_paged = models
    P, W, n_pages = 4, CACHE // 4, 24
    perm = np.random.default_rng(9).permutation(n_pages)
    tbl = perm[:2 * W].reshape(2, W).astype(np.int32)
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(prompts)},
                           cache_len=CACHE)
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_len=CACHE)

    def to_pages(c, zeros):
        L, B, S, KV, E = c.shape
        return zeros.at[:, tbl.reshape(-1)].set(
            c.reshape(L, B * W, P, KV, E))

    jz = jnp.zeros((jcfg.n_layers, n_pages, P, jcfg.n_kv_heads,
                    jcfg.head_dim), jnp.bfloat16)
    jpages = {"attn": {n: to_pages(jc["attn"][n], jz) for n in ("k", "v")}}
    tpages = {"attn": {}}
    for n in ("k", "v"):
        pool = torch.zeros(tuple(jz.shape), dtype=torch.bfloat16)
        L, B, S, KV, E = tc["attn"][n].shape
        pool[:, torch.from_numpy(tbl.reshape(-1)).long()] = \
            tc["attn"][n].reshape(L, B * W, P, KV, E)
        tpages["attn"][n] = pool
    ttbl = torch.from_numpy(tbl)
    tok = _greedy(jl)
    for step in range(STEPS):
        pos = PROMPT + step
        jl, jpages = jdec_paged(jp, jpages, jnp.asarray(tok), jnp.int32(pos),
                                jnp.asarray(tbl))
        tl, tpages = tm.decode_fn(tp, tpages, torch.from_numpy(tok), pos,
                                  page_table=ttbl, page_size=P)
        assert _err(jl, tl) <= BF16_TOL, step
        for name in ("k", "v"):
            assert _err(jpages["attn"][name], tpages["attn"][name]) \
                <= BF16_TOL
        tok = _greedy(jl)


def test_paged_decode_equals_dense_decode_bit_for_bit(models, prompts):
    """Within the port: the same step over a page pool and over the dense
    rows gives the same logits and writes the same column, bit for bit."""
    tm, tp = models[3], models[5]
    P, W = 4, CACHE // 4
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_len=CACHE)
    tbl = torch.arange(2 * W, dtype=torch.int32).reshape(2, W).flip(0)
    pages = {"attn": {}}
    for n in ("k", "v"):
        L, B, S, KV, E = tc["attn"][n].shape
        pool = torch.zeros(L, 2 * W, P, KV, E, dtype=torch.bfloat16)
        pool[:, tbl.reshape(-1).long()] = tc["attn"][n].reshape(
            L, B * W, P, KV, E)
        pages["attn"][n] = pool
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    dl, tc = tm.decode_fn(tp, tc, tok, PROMPT)
    pl_, pages = tm.decode_fn(tp, pages, tok, PROMPT, page_table=tbl,
                              page_size=P)
    assert torch.equal(dl, pl_)
    for n in ("k", "v"):
        L, B, S, KV, E = tc["attn"][n].shape
        back = pages["attn"][n][:, tbl.reshape(-1).long()].reshape(
            L, B, S, KV, E)
        assert torch.equal(back, tc["attn"][n])
