"""The port's moe family (``repro_torch.models.moe`` and the transformer
with ``family="moe"``) held against the JAX package on the CPU at reduced
width, with the JAX weights carried over through ``from_jax_params``:

* ``granite-moe-3b-a800m`` reduced — 2 layers, d 256, 4 heads over 2 KV
  heads, head_dim 64, 4 experts of d_ff 128, top-2, the dense router,
  routing groups of 64, vocab 512;
* ``llama4-scout-17b-a16e`` reduced — the dispatch (capacity) router and
  the shared expert: 4 experts of d_ff 128, top-1, a shared expert of
  128, layer 0 global and layer 1 windowed at 64.

The JAX side runs ``kernel_impl="pallas"`` (its decode attention is the
Pallas decode kernel in interpret mode, whose f32 scores match the
port's); its MoE is plain jnp on every path, as the port's CPU path is.
bf16 outputs agree at 2e-2 normalised; decode is compared teacher-forced
(both fed the JAX run's tokens).

The weights are drawn by JAX, then every layer-stacked lecun weight but
the router is scaled to the port's per-layer fan-in (``_port_scaled``).
The reference draws them at 1/sqrt(L) (ROADMAP queue 3): at L = 2 the
expert outputs reach ~3e3 and the attention is near one-hot, so a single
bf16 rounding that XLA and PyTorch take apart (their bf16 silu differs
in ~30 % of elements by an ulp) flips a near-tied attention and moves a
whole token (0.06 of the logits' scale after 2 decode steps), while each
layer's MoE and attention agree to an ulp on equal inputs.  The router
keeps the reference's sharp scale: a near-tie between a selected and an
unselected expert then concerns weights near 0.  A top-1 router
(llama4-scout) renormalises its choice to weight 1, so there a near-tie
swaps a token's whole FFN: its model is held layer by layer, every MoE
block on the same activations in both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import (ParamSpec, from_jax_params,  # noqa: E402
                                param_bytes)

BF16_TOL = 2e-2
F32_TOL = 1e-5
STEPS, CACHE = 8, 128
GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


def _port_scaled(specs, params):
    """JAX-drawn parameters with every stacked lecun weight but the
    router rescaled from the reference's 1/sqrt(L) to the port's scale
    (``_jax_init``)."""
    def one(ps, a):
        if ps.init != "lecun" or ps.axes[0] != "layers" or \
                ps.axes[-1] == "experts":
            return a
        scale = np.sqrt(ps.shape[0]) * _jax_init(ps)[3]
        return (a.astype(jnp.float32) * scale).astype(a.dtype)
    return jax.tree.map(one, specs, params,
                        is_leaf=lambda x: isinstance(x, JaxParamSpec))


def _build(name):
    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = _port_scaled(jm.param_specs(),
                      init_spec_tree(jm.param_specs(), jax.random.PRNGKey(0)))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jpre = jax.jit(lambda p, t: jm.prefill_fn(p, {"tokens": t},
                                              cache_len=CACHE,
                                              kernel_impl="pallas"))
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos,
                                                     kernel_impl="pallas"))
    return jcfg, tcfg, jm, tm, jp, tp, jpre, jdec


@pytest.fixture(scope="module")
def granite():
    return _build(GRANITE)


@pytest.fixture(scope="module")
def llama4():
    return _build(LLAMA4)


def _prompts(n, S, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, S)).astype(np.int32)


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# configs, parameter trees, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirrors_jax_fields(name, reduced):
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "moe":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert tcfg.family == "moe" and tcfg.supports_decode
    if name == GRANITE and not reduced:
        m = tcfg.moe
        assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                tcfg.head_dim, tcfg.vocab, m.num_experts, m.top_k,
                m.d_ff_expert, m.router_impl) == (
                    32, 1536, 24, 8, 64, 49155, 40, 8, 512, "dense")


def test_full_width_weights():
    """granite-moe-3b-a800m holds ~3.3 B parameters (6.6 GB of bf16: one
    card); llama4-scout-17b-a16e's ~214 GB do not fit an 80 GB card."""
    g = param_bytes(build_model(get_arch(GRANITE)).param_specs())
    ll = param_bytes(build_model(get_arch(LLAMA4)).param_specs())
    assert 6.0e9 < g < 7.0e9
    assert ll > 200e9


def _jax_init(ps):
    """The reference's init recipe as the port draws it: a stacked lecun
    weight's fan-in taken per layer (shape[1]; the reference takes the
    layer axis), and the expert weights wi/wg/wo at 1/sqrt of their
    contracted axis (shape[2]; the reference takes the layer axis, and a
    per-layer fan-in would take the expert axis) — quirks recorded in
    ROADMAP.md."""
    if ps.init == "lecun" and ps.axes[:2] == ("layers", "experts"):
        return (tuple(ps.shape), ps.dtype, "normal",
                float(1.0 / np.sqrt(ps.shape[2])))
    if ps.init == "lecun" and ps.axes[0] == "layers":
        return (tuple(ps.shape), ps.dtype, "normal",
                float(1.0 / np.sqrt(ps.shape[1])))
    return (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale)


@pytest.mark.parametrize("fixture", ["granite", "llama4"])
def test_param_and_cache_specs_match_jax(fixture, request):
    jcfg, tcfg, jm, tm = request.getfixturevalue(fixture)[:4]
    want = jax.tree.map(_jax_init, jm.param_specs(),
                        is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = jax.tree.map(
        lambda ps: (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale),
        tm.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    assert got == want
    assert set(got["layers"]) == {"ln1", "attn", "ln2", "moe"}
    shared = {"shared_wi", "shared_wg", "shared_wo"}
    assert (set(got["layers"]["moe"]) >= shared) == (fixture == "llama4")
    for specs, jspecs in ((tm.cache_specs(3, 64), JT.cache_specs(jcfg, 3, 64)),
                          (tm.page_specs(8, 4), JT.page_specs(jcfg, 8, 4))):
        jc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype), jspecs,
                          is_leaf=lambda x: isinstance(x, JaxParamSpec))
        tc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype), specs,
                          is_leaf=lambda x: isinstance(x, ParamSpec))
        assert tc == jc and set(tc) == {"attn"}


# ---------------------------------------------------------------------------
# the MoE block vs JAX
# ---------------------------------------------------------------------------

def _moe_case(fixture, request, fused):
    jcfg, tcfg, _, _, jp, tp = request.getfixturevalue(fixture)[:6]
    jcfg = dataclasses.replace(jcfg, moe_dense_fused=fused)
    tcfg = dataclasses.replace(tcfg, moe_dense_fused=fused)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    return jcfg, tcfg, jl, tl


@pytest.mark.parametrize("fixture,fused,B,S", [
    ("granite", False, 2, 40),      # one routing group of 80 > 64: 40
    ("granite", True, 2, 40),       # the fused combine
    ("granite", False, 3, 1),       # a decode step's 3 tokens
    ("llama4", False, 2, 96),       # dispatch: 3 groups of 64, drops
    ("llama4", False, 1, 5),
])
def test_moe_apply_matches_jax(fixture, fused, B, S, request):
    """y and aux against ``repro.models.moe.moe_apply``, and the top-k
    expert sets equal."""
    jcfg, tcfg, jl, tl = _moe_case(fixture, request, fused)
    x = _x((B, S, jcfg.d_model), seed=B * 100 + S)
    yj, aj = JM.moe_apply(jcfg, jl, jnp.asarray(x))
    yt, at = TM.moe_apply(tcfg, tl, _t(x))
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (B, S,
                                                             jcfg.d_model)
    assert _err(yj, yt) <= BF16_TOL
    assert abs(float(aj) - float(at)) <= F32_TOL * max(1.0, abs(float(aj)))
    T = B * S
    g = TM._group_size(tcfg.moe.router_group, T)
    xg = _t(x).reshape(T // g, g, -1)
    _, _, idx = TM.route(tcfg, tl, xg)
    logits = jnp.einsum("gsd,de->gse",
                        jnp.asarray(x, jnp.float32).reshape(T // g, g, -1),
                        jl["router"])
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), tcfg.moe.top_k)
    assert np.array_equal(np.sort(idx.numpy(), -1),
                          np.sort(np.asarray(jidx), -1))


def test_dispatch_drops_tokens_past_capacity(llama4, request):
    """96 tokens in groups of 64 and 32 with top-1 of 4 experts: cap =
    int(g * 1.25 / 4); a token past its expert's capacity gets no routed
    output (only the shared expert's), as in the reference."""
    jcfg, tcfg, jl, tl = _moe_case("llama4", request, False)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, shared_expert=False))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, shared_expert=False))
    x = _x((1, 96, jcfg.d_model), seed=7)
    yj, _ = JM.moe_apply(jcfg, jl, jnp.asarray(x))
    yt, _ = TM.moe_apply(tcfg, tl, _t(x))
    dropped_j = np.all(np.asarray(yj, np.float32) == 0, -1)
    dropped_t = (yt.float() == 0).all(-1).numpy()
    assert dropped_t.any() and np.array_equal(dropped_t, dropped_j)
    assert _err(yj, yt) <= BF16_TOL


# ---------------------------------------------------------------------------
# prefill and teacher-forced decode vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [8, 70])
def test_prefill_matches_jax(granite, S):
    jcfg, _, _, tm, jp, tp, jpre, _ = granite
    prompts = _prompts(2, S, jcfg.vocab, seed=S)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                           cache_len=CACHE)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    assert _err(jl, tl) <= BF16_TOL
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
        assert _err(jc["attn"][name], tc["attn"][name]) <= BF16_TOL


def _greedy(logits):
    return np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]


def test_decode_teacher_forced_matches_jax(granite):
    jcfg, _, _, tm, jp, tp, jpre, jdec = granite
    S = 70
    prompts = _prompts(2, S, jcfg.vocab, seed=1)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_len=CACHE)
    tok = _greedy(jl)
    for step in range(STEPS):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(S + step))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), S + step)
        assert _err(jl, tl) <= BF16_TOL, step
        for name in ("k", "v"):
            assert _err(jc["attn"][name], tc["attn"][name]) <= BF16_TOL
        tok = _greedy(jl)          # both fed the JAX run's tokens


def test_layer_windows_match_jax():
    """The reduced llama4-scout: layer 0 global, layer 1 windowed at 64."""
    jcfg, tcfg = jax_get_arch(LLAMA4).reduced(), get_arch(LLAMA4).reduced()
    got = TT.layer_windows(tcfg, 2048)
    assert np.array_equal(got, JT.layer_windows(jcfg, 2048))
    assert got.tolist() == [int(TT.GLOBAL_WINDOW), 64]


@pytest.mark.parametrize("S", [8, 96])
def test_llama4_moe_blocks_match_jax_on_prefill_activations(llama4, S):
    """Every layer's MoE block (the dispatch router and the shared expert)
    on the activations of the port's own prefill — 96 runs past layer 1's
    64-position window — against ``repro.models.moe.moe_apply`` on the
    same input; the transformer's ``moe_ffn`` gives ``moe_apply``'s y bit
    for bit."""
    jcfg, tcfg, _, tm, jp, tp = llama4[:6]
    prompts = _prompts(2, S, jcfg.vocab, seed=S)
    seen = []
    real = TM.moe_ffn

    def record(cfg, p, x):
        y = real(cfg, p, x)
        seen.append((x, y, p))
        return y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "moe_ffn", record)
        tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                      cache_len=CACHE)
    assert len(seen) == tcfg.n_layers
    for i, (x, y_ffn, tl) in enumerate(seen):
        y, aux = TM.moe_apply(tcfg, tl, x)
        assert torch.equal(y, y_ffn), i
        jl = jax.tree.map(lambda a: a[i], jp["layers"]["moe"])
        yj, aj = JM.moe_apply(jcfg, jl, jnp.asarray(
            x.float().numpy(), jnp.bfloat16))
        assert _err(yj, y) <= BF16_TOL, i
        assert abs(float(aj) - float(aux)) <= F32_TOL * max(1.0,
                                                             abs(float(aj)))


def test_paged_decode_matches_dense(granite):
    """The moe family takes the paged layout: one step over a page pool
    holding the prefill's rows gives the dense layout's logits bit for
    bit."""
    tcfg, tm, tp = granite[1], granite[3], granite[5]
    P, S = 4, 10
    prompt = torch.from_numpy(_prompts(1, S, tcfg.vocab, seed=4))
    _, dense = tm.prefill_fn(tp, {"tokens": prompt}, cache_len=16)
    pool = {n: torch.zeros((tcfg.n_layers, 8, P) + dense["attn"][n].shape[3:],
                           dtype=torch.bfloat16) for n in ("k", "v")}
    table = torch.tensor([[5, 2, 7, 0]], dtype=torch.int32)
    for n in ("k", "v"):
        rows = dense["attn"][n][:, 0].reshape(tcfg.n_layers, 4, P, -1,
                                              tcfg.head_dim)
        pool[n][:, table[0].long()] = rows
    tok = torch.tensor([[3]], dtype=torch.int32)
    want, _ = tm.decode_fn(tp, dense, tok, S)
    got, _ = tm.decode_fn(tp, {"attn": pool}, tok, S, page_table=table,
                          page_size=P)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# contracts within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 20, 64])
def test_prefill_then_decode_equals_longer_prefill(granite, n):
    """prefill(n) + one decode step gives prefill(n + 1)'s next-token
    logits and K/V rows, within the bf16 tolerance (the two paths round
    attention apart); layer 0's K/V bit for bit."""
    tcfg, tm, tp = granite[1], granite[3], granite[5]
    prompt = torch.from_numpy(_prompts(1, n + 1, tcfg.vocab, seed=10 + n))
    _, cache = tm.prefill_fn(tp, {"tokens": prompt[:, :n]}, cache_len=CACHE)
    step_logits, cache = tm.decode_fn(tp, cache, prompt[:, n:], n)
    want_logits, want = tm.prefill_fn(tp, {"tokens": prompt},
                                      cache_len=CACHE)
    assert _err(want_logits.float().numpy(), step_logits) <= BF16_TOL
    for name in ("k", "v"):
        got = cache["attn"][name][:, :, :n + 1]
        assert _err(want["attn"][name][:, :, :n + 1].float().numpy(),
                    got) <= BF16_TOL
        assert torch.equal(got[0], want["attn"][name][0, :, :n + 1])
