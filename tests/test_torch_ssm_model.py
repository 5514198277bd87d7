"""The port's ssm family (``repro_torch.models.{ssm,transformer,api}``)
held against the JAX package on the CPU at the reduced ``mamba2-370m``
width (2 layers, d_model 256, d_inner 512 as 32 heads of P = 16, state
N = 16, chunk 16, conv width 4, vocab 512), with the JAX weights carried
over through ``from_jax_params``.

The JAX side runs ``kernel_impl="pallas"``: its SSD is the Pallas kernel
in interpret mode, which asserts S % Q == 0, so the prompts held against
it are multiples of the chunk (or shorter than one chunk).  bf16 outputs
agree at 2e-2 normalised, the f32 SSM state at 1e-5 where both sides see
the same bf16 inputs (the SSD alone) and at 2e-2 through the model, whose
bf16 projections round differently in the two frameworks.  Decode is
compared teacher-forced: both sides are fed the JAX run's tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as TSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import ParamSpec, from_jax_params, init_params  # noqa: E402

BF16_TOL = 2e-2
F32_TOL = 1e-5
# the f32 SSM state after one block: the two frameworks' SSD inputs are
# bf16 activations that round apart (silu, the bf16 projections), which
# leaves the state 6.5e-4 (sequence) and 9.5e-4 (step) apart.  Through
# the stack (prefill, decode) each layer's state also follows the bf16
# residual stream and is held at BF16_TOL (1.2e-2 and 1.3e-2 measured).
STATE_TOL = 2e-3
STEPS = 8


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("mamba2-370m").reduced()
    tcfg = get_arch("mamba2-370m").reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = init_spec_tree(jm.param_specs(), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jpre = jax.jit(lambda p, t: jm.prefill_fn(p, {"tokens": t},
                                              kernel_impl="pallas"))
    jdec = jax.jit(lambda p, c, t: jm.decode_fn(p, c, t, jnp.int32(0),
                                                kernel_impl="pallas"))
    return jcfg, tcfg, jm, tm, jp, tp, jpre, jdec


def _prompts(n, S, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirrors_jax_fields(reduced):
    jcfg, tcfg = jax_get_arch("mamba2-370m"), get_arch("mamba2-370m")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "ssm":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert tcfg.family == "ssm" and tcfg.supports_decode
    d_inner, H = TSM.ssm_dims(tcfg)
    assert (d_inner, H) == JS.ssm_dims(jcfg)
    if not reduced:
        assert (tcfg.n_layers, d_inner, H, tcfg.ssm.state_dim,
                tcfg.ssm.chunk, tcfg.vocab) == (48, 2048, 32, 128, 256,
                                                50280)


def _jax_init(ps):
    """The reference's init recipe with a stacked lecun weight's fan-in
    taken per layer (shape[1]), as the port draws it (ROADMAP queue 3)."""
    if ps.init == "lecun" and ps.axes[0] == "layers":
        return (tuple(ps.shape), ps.dtype, "normal",
                float(1.0 / np.sqrt(ps.shape[1])))
    return (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale)


def _spec_tuple(ps):
    return (tuple(ps.shape), ps.dtype, ps.init, ps.init_scale)


def test_param_and_cache_specs_match_jax(models):
    jcfg, tcfg, jm, tm = models[:4]
    want = jax.tree.map(_jax_init, jm.param_specs(),
                        is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = jax.tree.map(_spec_tuple, tm.param_specs(),
                       is_leaf=lambda x: isinstance(x, ParamSpec))
    assert got == want
    assert set(got["layers"]) == {"ln1", "ssm"}
    jc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      JT.cache_specs(jcfg, 3, 64),
                      is_leaf=lambda x: isinstance(x, JaxParamSpec))
    tc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      tm.cache_specs(3, 64),
                      is_leaf=lambda x: isinstance(x, ParamSpec))
    assert tc == jc


def test_init_small_a_log_and_per_layer_fan_in(models):
    tcfg, tm = models[1], models[3]
    p = init_params(tm.param_specs(), seed=3, device="cpu")["layers"]["ssm"]
    a = p["A_log"]
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 32)
    assert float(a.min()) >= 0.0 and float(a.max()) < np.log(16.0)
    assert torch.equal(p["D"], torch.ones(2, 32))
    assert not p["dt_bias"].any()
    wx = p["wx"]
    assert wx.dtype == torch.bfloat16
    # lecun at the per-layer fan-in d, not at the layer count
    assert abs(float(wx.float().std()) * np.sqrt(tcfg.d_model) - 1) < 0.05


def test_other_families_and_paged_ssm_raise(models):
    tcfg, tm, tp = models[1], models[3], models[5]
    with pytest.raises(NotImplementedError, match="encdec.py"):
        TT.layer_param_specs(dataclasses.replace(tcfg, family="encdec"))
    with pytest.raises(ValueError, match="attention-only"):
        tm.page_specs(8, 4)
    cache = {"ssm": {}}
    with pytest.raises(ValueError, match="attention-only"):
        tm.decode_fn(tp, cache, torch.zeros(1, 1, dtype=torch.int32), 3,
                     page_table=torch.zeros(1, 2, dtype=torch.int32),
                     page_size=4)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 9, 24)),
                               jnp.bfloat16))
    k = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want = JS.causal_conv_seq(jnp.asarray(x), jnp.asarray(k))
    got = TSM.causal_conv_seq(tx, torch.from_numpy(k))
    assert _err(want, got) <= BF16_TOL
    buf, xt = x[:, :3], x[:, 3]
    jb, jy = JS.causal_conv_step(jnp.asarray(buf), jnp.asarray(xt),
                                 jnp.asarray(k))
    tb, ty = TSM.causal_conv_step(tx[:, :3], tx[:, 3], torch.from_numpy(k))
    assert torch.equal(tb, tx[:, 1:4])
    assert _err(jy, ty) <= BF16_TOL
    # the step at position 3 is the sequence conv's row 3
    assert torch.equal(ty, got[:, 3])


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(2)
    B, H, N, P = 2, 4, 8, 16
    h = rng.standard_normal((B, H, N, P)).astype(np.float32)
    xt = rng.standard_normal((B, H, P)).astype(np.float32)
    dtt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bt = rng.standard_normal((B, H, N)).astype(np.float32)
    Ct = rng.standard_normal((B, H, N)).astype(np.float32)
    jh, jy = JS.ssd_step(*(jnp.asarray(a) for a in (h, xt, dtt, A, Bt, Ct)))
    th, ty = TSM.ssd_step(*(torch.from_numpy(a)
                            for a in (h, xt, dtt, A, Bt, Ct)))
    assert _err(jh, th) <= F32_TOL and _err(jy, ty) <= F32_TOL


def _block_inputs(models, S, seed):
    jcfg = models[0]
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, S, jcfg.d_model)),
                               jnp.bfloat16))
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("S", [16, 48])
def test_mamba2_seq_matches_jax_pallas(models, S):
    jcfg, tcfg, _, _, jp, tp = models[:6]
    jx, tx = _block_inputs(models, S, seed=S)
    jl, tl = _layer(jp["layers"]["ssm"], 1), _layer(tp["layers"]["ssm"], 1)
    jo, (jconv, jh) = JS.mamba2_seq(jcfg, jl, jnp.asarray(jx),
                                    kernel_impl="pallas")
    to, (tconv, th) = TSM.mamba2_seq(tcfg, tl, tx)
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
    assert _err(jo, to) <= BF16_TOL
    assert _err(jh, th) <= STATE_TOL
    for k in ("x", "B", "C"):
        assert tuple(tconv[k].shape) == jconv[k].shape
        assert _err(jconv[k], tconv[k]) <= BF16_TOL


def test_mamba2_step_matches_jax(models):
    jcfg, tcfg, _, _, jp, tp = models[:6]
    rng = np.random.default_rng(4)
    jx, tx = _block_inputs(models, 1, seed=5)
    d_inner, H = TSM.ssm_dims(tcfg)
    GN = tcfg.ssm.n_groups * tcfg.ssm.state_dim
    conv = {k: np.asarray(jnp.asarray(rng.standard_normal((2, 3, n)),
                                      jnp.bfloat16))
            for k, n in (("x", d_inner), ("B", GN), ("C", GN))}
    h = rng.standard_normal((2, H, tcfg.ssm.state_dim,
                             tcfg.ssm.head_dim)).astype(np.float32)
    jl, tl = _layer(jp["layers"]["ssm"], 0), _layer(tp["layers"]["ssm"], 0)
    jo, (jconv, jh) = JS.mamba2_step(
        jcfg, jl, jnp.asarray(jx), {k: jnp.asarray(v)
                                    for k, v in conv.items()},
        jnp.asarray(h))
    to, (tconv, th) = TSM.mamba2_step(
        tcfg, tl, tx, {k: torch.from_numpy(v.astype(np.float32)).to(
            torch.bfloat16) for k, v in conv.items()},
        torch.from_numpy(h))
    assert _err(jo, to) <= BF16_TOL
    assert _err(jh, th) <= STATE_TOL
    for k in conv:
        assert _err(jconv[k], tconv[k]) == 0.0


# ---------------------------------------------------------------------------
# prefill and teacher-forced decode vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [11, 32])
def test_prefill_matches_jax(models, S):
    jcfg, _, _, tm, jp, tp, jpre, _ = models
    prompts = _prompts(2, S, jcfg.vocab, seed=S)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)},
                           cache_len=64)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    assert _err(jl, tl) <= BF16_TOL
    assert _err(jc["ssm"]["h"], tc["ssm"]["h"]) <= BF16_TOL
    for k in ("x", "B", "C"):
        assert tuple(tc["ssm"]["conv"][k].shape) == \
            jc["ssm"]["conv"][k].shape
        assert _err(jc["ssm"]["conv"][k], tc["ssm"]["conv"][k]) <= BF16_TOL


def _greedy(logits):
    return np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]


def test_decode_teacher_forced_matches_jax(models):
    jcfg, _, _, tm, jp, tp, jpre, jdec = models
    prompts = _prompts(2, 16, jcfg.vocab, seed=1)
    jl, jc = jpre(jp, jnp.asarray(prompts))
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)})
    tok = _greedy(jl)
    for step in range(STEPS):
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), 16 + step)
        assert _err(jl, tl) <= BF16_TOL, step
        assert _err(jc["ssm"]["h"], tc["ssm"]["h"]) <= BF16_TOL, step
        for k in ("x", "B", "C"):
            assert _err(jc["ssm"]["conv"][k], tc["ssm"]["conv"][k]) \
                <= BF16_TOL, step
        tok = _greedy(jl)          # both fed the JAX run's tokens


# ---------------------------------------------------------------------------
# contracts within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 20])
def test_prefill_then_decode_equals_longer_prefill(models, n):
    """prefill(n) + one decode step gives prefill(n + 1)'s next-token
    logits and decode state.  n = 1 and 2 are shorter than the conv
    window (conv_width - 1 = 3): the zero-padded window keeps them right
    (the reference's broadcast row is off by ~1 there); n = 20 leaves a
    ragged chunk of 4 behind a full one."""
    tcfg, tm, tp = models[1], models[3], models[5]
    prompt = torch.from_numpy(_prompts(1, n + 1, tcfg.vocab, seed=10 + n))
    _, cache = tm.prefill_fn(tp, {"tokens": prompt[:, :n]})
    step_logits, cache = tm.decode_fn(tp, cache, prompt[:, n:], n)
    want_logits, want = tm.prefill_fn(tp, {"tokens": prompt})
    assert _err(want_logits.float().numpy(), step_logits) <= BF16_TOL
    assert _err(want["ssm"]["h"].numpy(), cache["ssm"]["h"]) <= F32_TOL
    for k in ("x", "B", "C"):
        assert torch.equal(cache["ssm"]["conv"][k], want["ssm"]["conv"][k])


def test_fault2_short_prompt_keeps_a_zero_padded_window(models):
    """A 2-token prompt: the reference keeps 1 conv row (ssm.py:209-211);
    the port keeps conv_width - 1 = 3 rows, [0, x0, x1]."""
    jcfg, _, _, tm, jp, tp, jpre, _ = models
    prompts = _prompts(1, 2, jcfg.vocab, seed=3)
    _, jc = jpre(jp, jnp.asarray(prompts))
    assert jc["ssm"]["conv"]["x"].shape[2] == 1
    _, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(prompts)})
    cx = tc["ssm"]["conv"]["x"]
    assert cx.shape[2] == 3
    assert not cx[:, :, 0].any() and cx[:, :, 1:].abs().sum() > 0
    assert _err(jc["ssm"]["conv"]["x"][:, :, 0], cx[:, :, 2]) <= BF16_TOL
