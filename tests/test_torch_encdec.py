"""The port's encoder-decoder (``repro_torch.models.encdec``, the encdec
family) held against the JAX package on the CPU at the reduced
``whisper-large-v3`` width (1 encoder and 2 decoder layers, d 256, 4
heads over 2 KV heads, head_dim 64, vocab 512).

Weights are drawn with numpy from a seed on the port's specs (the
per-layer lecun fan-in, ROADMAP queue 3), the attention biases set non-
zero, and handed to both packages (the port's through
``from_jax_params``); frames and tokens are numpy draws too.  The
encoder output, the prefill logits, both caches and 4 teacher-forced
decode steps agree at the bf16 tolerance (2e-2, normalised by the
reference's max-abs; docs/kernels.md §Oracle tolerances).  The
reference's decode attends with bf16 scores (its jnp path), the port's
plain K7 with f32 scores: at these unit-scale weights the two stay well
inside it.  ``sinusoidal_positions``: XLA's f32 ``exp`` and PyTorch's
differ by one ulp at 43 of whisper's 640 frequencies (each at most 1,
so by at most 2^-23), and the angle position x frequency by up to
position x 2^-23; the sinusoids are held at 1e-6 plus that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.sharding import ParamSpec as JaxParamSpec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import ParamSpec, from_jax_params  # noqa: E402

BF16_TOL = 2e-2
ARCH = "whisper-large-v3"
B, S_ENC, PROMPT, CACHE, STEPS = 2, 48, 7, 16, 4


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def numpy_params(spec_tree, seed):
    """A parameter tree drawn with numpy on the port's specs: zeros, ones,
    normal(0, init_scale) (a stacked lecun weight is a normal of its
    per-layer fan-in there), bf16 leaves as ml_dtypes' bfloat16."""
    rng = np.random.default_rng(seed)

    def one(ps):
        if isinstance(ps, dict):
            return {k: one(ps[k]) for k in sorted(ps)}
        if ps.init == "zeros":
            a = np.zeros(ps.shape, np.float32)
        elif ps.init == "ones":
            a = np.ones(ps.shape, np.float32)
        else:
            a = rng.standard_normal(ps.shape).astype(np.float32)
            a *= np.float32(ps.init_scale)
        return np.asarray(a, jnp.bfloat16 if ps.dtype == "bfloat16"
                          else np.float32)
    return one(spec_tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    npp = numpy_params(tm.param_specs(), 0)
    rng = np.random.default_rng(1)
    for stack in ("enc_layers", "dec_layers"):
        for attn in [k for k in npp[stack] if k.endswith("attn")]:
            for b in ("bq", "bk", "bv", "bo"):
                shape = npp[stack][attn][b].shape
                npp[stack][attn][b] = (0.1 * rng.standard_normal(shape)
                                       ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = from_jax_params(npp)
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos))
    return jcfg, tcfg, jm, tm, jp, tp, jdec


@pytest.fixture(scope="module")
def inputs(models):
    tcfg = models[1]
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((B, S_ENC, tcfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, tcfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    return frames, toks


def _jax_batch(frames, toks):
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}


def _torch_batch(frames, toks):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks)}


# ---------------------------------------------------------------------------
# specs and the building block
# ---------------------------------------------------------------------------

def test_param_and_cache_specs_match_jax(models):
    """The same tree, shapes and dtypes as the reference's; a stacked
    lecun weight keeps its per-layer fan-in, as the decoder-only stack's
    do."""
    jcfg, tcfg, jm, tm = models[:4]
    want = jax.tree.map(
        lambda ps: (tuple(ps.shape), ps.dtype,
                    float(1 / np.sqrt(ps.shape[1])) if ps.init == "lecun"
                    else ps.init_scale),
        jm.param_specs(), is_leaf=lambda x: isinstance(x, JaxParamSpec))
    got = jax.tree.map(
        lambda ps: (tuple(ps.shape), ps.dtype, ps.init_scale),
        tm.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    assert got == want
    assert tcfg.n_enc_layers == 1 and tcfg.frontend == "audio"
    jc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      JE.cache_specs(jcfg, 3, 20, 48),
                      is_leaf=lambda x: isinstance(x, JaxParamSpec))
    tc = jax.tree.map(lambda ps: (tuple(ps.shape), ps.dtype),
                      tm.cache_specs(3, 20, 48),
                      is_leaf=lambda x: isinstance(x, ParamSpec))
    assert tc == jc


@pytest.mark.parametrize("d", [256, 1280])
def test_sinusoidal_positions_match_jax(d):
    pos = np.arange(1500)[None].repeat(2, 0).astype(np.int32)
    want = np.asarray(JC.sinusoidal_positions(jnp.asarray(pos), d))
    got = TC.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-6 + pos[..., None] * 2.0 ** -23
    assert (np.abs(got.numpy() - want) <= bound).all()
    # the frequencies themselves (position 1's angles) to 1e-6
    assert np.abs(got.numpy()[:, 1] - want[:, 1]).max() <= 1e-6


# ---------------------------------------------------------------------------
# encode, prefill, teacher-forced decode vs JAX
# ---------------------------------------------------------------------------

def test_encode_matches_jax(models, inputs):
    jcfg, tcfg, _, _, jp, tp, _ = models
    frames, _ = inputs
    want = JE.encode(jcfg, jp, jnp.asarray(frames))
    got = TE.encode(tcfg, tp, torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _err(want, got) <= BF16_TOL


def test_prefill_logits_and_caches_match_jax(models, inputs):
    _, _, jm, tm, jp, tp, _ = models
    frames, toks = inputs
    jl, jc = jm.prefill_fn(jp, _jax_batch(frames, toks[:, :PROMPT]),
                           cache_len=CACHE)
    tl, tc = tm.prefill_fn(tp, _torch_batch(frames, toks[:, :PROMPT]),
                           cache_len=CACHE)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    assert _err(jl, tl) <= BF16_TOL
    for part in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(tc[part][name].shape) == jc[part][name].shape
            assert _err(jc[part][name], tc[part][name]) <= BF16_TOL
    assert not tc["self"]["k"][:, :, PROMPT:].any()


def test_decode_teacher_forced_matches_jax(models, inputs):
    """4 steps, both packages fed the JAX run's greedy tokens; the self
    cache's new columns and the untouched cross cache held too."""
    _, _, jm, tm, jp, tp, jdec = models
    frames, toks = inputs
    jl, jc = jm.prefill_fn(jp, _jax_batch(frames, toks[:, :PROMPT]),
                           cache_len=CACHE)
    _, tc = tm.prefill_fn(tp, _torch_batch(frames, toks[:, :PROMPT]),
                          cache_len=CACHE)
    cross = tc["cross"]["k"].clone()
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(STEPS):
        pos = PROMPT + step
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), pos)
        assert _err(jl, tl) <= BF16_TOL, step
        for name in ("k", "v"):
            assert _err(jc["self"][name], tc["self"][name]) <= BF16_TOL
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    assert torch.equal(tc["cross"]["k"], cross)


def test_prefill_decode_consistency(models, inputs):
    """The reference's property (tests/test_models.py,
    ``test_prefill_decode_consistency_encdec``) on the port: decoding
    token T after a prefill of T tokens gives the logits of a prefill of
    T + 1 tokens, at its tolerance (0.11)."""
    tm, tp = models[3], models[5]
    frames, toks = inputs
    T = PROMPT + 2
    full, _ = tm.prefill_fn(tp, _torch_batch(frames, toks[:, :T + 1]),
                            cache_len=T + 1)
    _, cache = tm.prefill_fn(tp, _torch_batch(frames, toks[:, :T]),
                             cache_len=T + 1)
    lg, _ = tm.decode_fn(tp, cache, torch.from_numpy(toks[:, T:T + 1]), T)
    np.testing.assert_allclose(lg[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), atol=0.11,
                               rtol=0.11)


# ---------------------------------------------------------------------------
# what refuses the family
# ---------------------------------------------------------------------------

def test_no_page_table_and_no_server(models):
    """``decode_fn`` with a page table, ``page_specs``, ``Server`` and
    ``PagedServer`` refuse the encdec family with a ValueError, as the
    reference's ``decode_fn`` and servers do; the decoder-only stack
    refuses it by name."""
    tcfg, tm, tp = models[1], models[3], models[5]
    cache = {"self": {}, "cross": {}}
    with pytest.raises(ValueError, match="decoder-only"):
        tm.decode_fn(tp, cache, torch.zeros(1, 1, dtype=torch.int32), 3,
                     page_table=torch.zeros(1, 2, dtype=torch.int32),
                     page_size=4)
    with pytest.raises(ValueError, match="decoder-only"):
        tm.page_specs(8, 4)
    with pytest.raises(ValueError, match="decoder-only"):
        TS.Server(tcfg, slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        TS.PagedServer(tcfg, pool_pages=8, page_size=4, max_len=16,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="encdec.py"):
        TT.param_specs(tcfg)
    with pytest.raises(SystemExit):
        TS.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
