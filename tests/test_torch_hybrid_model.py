"""The port's hybrid family (``repro_torch.models.transformer`` with
``family="hybrid"``) held against the JAX package on the CPU at the
reduced ``hymba-1.5b`` width (2 layers, d 256, 4 heads over 2 KV heads,
head_dim 64, layer 0 global and layer 1 windowed at 64; the SSM branch
d_inner 512 as 32 heads of P = 16, state 16, chunk 16; vocab 512), with
the JAX weights carried over through ``from_jax_params``.

The JAX side runs ``kernel_impl="pallas"``: its SSD is the Pallas kernel
in interpret mode, which asserts S % 16 == 0, so the prompts held against
it are multiples of 16 (96 and 160 run past the window) or shorter than
one chunk (8); its decode attention is the Pallas decode kernel, whose
f32 scores match the port's.  Prefill attention on the CPU is the port's
``attn_seq``, the reference's own math.  bf16 outputs agree at 2e-2
normalised; decode is compared teacher-forced (both fed the JAX run's
tokens).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as TSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import ParamSpec, from_jax_params  # noqa: E402

BF16_TOL = 2e-2
F32_TOL = 1e-5
STEPS, CACHE = 8, 128


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("hymba-1.5b").reduced()
    tcfg = get_arch("hymba-1.5b").reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = init_spec_tree(jm.param_specs(), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jpre = jax.jit(lambda p, t: jm.prefill_fn(p, {"tokens": t},
                                              cache_len=CACHE,
                                              kernel_impl="pallas"))
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos,
                                                     kernel_impl="pallas"))
    return jcfg, tcfg, jm, tm, jp, tp, jpre, jdec


def _prompts(n, S, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, S)).astype(np.int32)


def _check_cache(jc, tc, tol=BF16_TOL):
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
        assert _err(jc["attn"][name], tc["attn"][name]) <= tol, name
    assert _err(jc["ssm"]["h"], tc["ssm"]["h"]) <= tol
    for k in ("x", "B", "C"):
        assert tuple(tc["ssm"]["conv"][k].shape) == \
            jc["ssm"]["conv"][k].shape
        assert _err(jc["ssm"]["conv"][k], tc["ssm"]["conv"][k]) <= tol, k


# ---------------------------------------------------------------------------
# configs, parameter trees, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirrors_jax_fields(reduced):
    jcfg, tcfg = jax_get_arch("hymba-1.5b"), get_arch("hymba-1.5b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "ssm":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert tcfg.family == "hybrid" and tcfg.supports_decode
    d_inner, H = TSM.ssm_dims(tcfg)
    if not reduced:
        assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                tcfg.head_dim, d_inner, H, tcfg.ssm.state_dim,
                tcfg.vocab) == (32, 1600, 25, 5, 64, 3200, 50, 16, 32001)


@pytest.mark.parametrize("reduced", [False, True])
def test_layer_windows_match_jax(reduced):
    jcfg, tcfg = jax_get_arch("hymba-1.5b"), get_arch("hymba-1.5b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    want = JT.layer_windows(jcfg, 2048)
    got = TT.layer_windows(tcfg, 2048)
    assert np.array_equal(got, want)
    glob = np.flatnonzero(got == TT.GLOBAL_WINDOW).tolist()
    assert glob == ([0] if reduced else [0, 15, 31])


def _jax_init(ps):
    """The reference's init recipe with a stacked lecun weight's fan-in
    taken per layer (shape[1]), as the port draws it (a reference quirk
    recorded in ROADMAP.md)."""
    if ps.init == "lecun" and ps.axes[0] == "layers":
        return (tuple(ps.shape), ps.dtype, "normal",
                float(1.0 / np.sqrt(ps.shape[1])))
    return (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale)


def test_param_and_cache_specs_match_jax(models):
    jcfg, tcfg, jm, tm = models[:4]
    want = jax.tree.map(_jax_init, jm.param_specs(),
                        is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = jax.tree.map(
        lambda ps: (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale),
        tm.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    assert got == want
    assert set(got["layers"]) == {"ln1", "attn", "ssm", "ln2", "mlp"}
    jc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      JT.cache_specs(jcfg, 3, 64),
                      is_leaf=lambda x: isinstance(x, JaxParamSpec))
    tc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      tm.cache_specs(3, 64),
                      is_leaf=lambda x: isinstance(x, ParamSpec))
    assert tc == jc and set(tc) == {"attn", "ssm"}


def test_paged_layouts_refuse_the_family(models):
    """As the reference: a page pool holds attention keys and values
    only, so the hybrid family's per-slot SSM state refuses it."""
    jcfg, tm, tp = models[0], models[3], models[5]
    with pytest.raises(ValueError, match="attention-only family"):
        JT.page_specs(jcfg, 8, 4)
    with pytest.raises(ValueError, match="attention-only family, got hybrid"):
        tm.page_specs(8, 4)
    with pytest.raises(ValueError, match="attention-only family, got hybrid"):
        tm.decode_fn(tp, {"attn": {}, "ssm": {}},
                     torch.zeros(1, 1, dtype=torch.int32), 3,
                     page_table=torch.zeros(1, 2, dtype=torch.int32),
                     page_size=4)


def test_hybrid_combine_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (np.asarray(jnp.asarray(rng.standard_normal((2, 5, 64)) * s,
                                   jnp.bfloat16)) for s in (3.0, 0.2))
    want = JT._hybrid_combine(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
              for x in (a, b))
    got = TT._hybrid_combine(ta, tb)
    assert got.dtype == torch.bfloat16
    assert _err(want, got) <= BF16_TOL


# ---------------------------------------------------------------------------
# prefill and teacher-forced decode vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [8, 96, 160])
def test_prefill_matches_jax(models, S):
    """8 is shorter than one SSD chunk and the window; 96 and 160 run past
    the 64-position window of layer 1."""
    jcfg, _, _, tm, jp, tp, jpre, _ = models
    prompts = _prompts(2, S, jcfg.vocab, seed=S)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                           cache_len=CACHE)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    assert _err(jl, tl) <= BF16_TOL
    _check_cache(jc, tc)


def _greedy(logits):
    return np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]


def test_decode_teacher_forced_matches_jax(models):
    """A 96-token prompt (past the window) and 8 decode steps: the
    windowed layer's decode attention drops the oldest positions."""
    jcfg, _, _, tm, jp, tp, jpre, jdec = models
    S = 96
    prompts = _prompts(2, S, jcfg.vocab, seed=1)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_len=CACHE)
    tok = _greedy(jl)
    for step in range(STEPS):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(S + step))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), S + step)
        assert _err(jl, tl) <= BF16_TOL, step
        _check_cache(jc, tc)
        tok = _greedy(jl)          # both fed the JAX run's tokens


# ---------------------------------------------------------------------------
# contracts within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 20, 100])
def test_prefill_then_decode_equals_longer_prefill(models, n):
    """prefill(n) + one decode step gives prefill(n + 1)'s next-token
    logits and decode state.  n = 1 and 2 are shorter than the conv
    window (a zero-padded window), 20 and 100 leave a ragged SSD chunk
    (100 runs past the window as well).  Layer 0's SSM block sees the
    same embedded input on both paths, so its state agrees to f32
    rounding and its conv window bit for bit; the rest follows the bf16
    residual stream, whose attention the two paths round apart."""
    tcfg, tm, tp = models[1], models[3], models[5]
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
    assert _err(want["ssm"]["h"][0].numpy(), cache["ssm"]["h"][0]) <= F32_TOL
    assert _err(want["ssm"]["h"].numpy(), cache["ssm"]["h"]) <= BF16_TOL
    for k in ("x", "B", "C"):
        assert torch.equal(cache["ssm"]["conv"][k][0],
                           want["ssm"]["conv"][k][0])
        assert _err(want["ssm"]["conv"][k].float().numpy(),
                    cache["ssm"]["conv"][k]) <= BF16_TOL
