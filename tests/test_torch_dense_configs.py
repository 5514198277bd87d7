"""The five configs this port adds last (``whisper-large-v3``,
``internvl2-2b``, ``phi3-medium-14b``, ``stablelm-12b``,
``command-r-35b``) against the reference's, and the three dense ones,
with stablelm-12b's head_dim of 160, held against the JAX package on the
CPU.

* Every config of the eleven equals the reference's field for field (the
  fields the port carries, the distribution fields and ``skip_shapes``
  among them), ``reduced()`` and ``optimized()`` included; the registry
  holds all eleven.
* The reduced phi3/stablelm/command-r (2 layers, d 256, 4 heads over 2 KV
  heads, head_dim 64, vocab 512) and the reduced stablelm at head_dim
  160 (``dataclasses.replace`` in both packages): a prefill and 4
  teacher-forced decode steps vs JAX at the bf16 tolerance (2e-2,
  normalised; docs/kernels.md §Oracle tolerances), weights numpy draws
  on the port's specs (``test_torch_encdec.numpy_params``).
* At E = 160 the plain K11 (``flash_attention_plain``) vs the
  reference's oracle ``attention_ref`` (f32 1e-5, bf16 2e-2), and K11's
  launch plan there (128-row items only); the plain K7 at E = 160 is held
  against the JAX Pallas decode kernel in ``test_torch_lm_kernels.py``.
* Weights that fit the card: command-r-35b's 60.57 GB pass
  ``require_weights_fit``, llama4-scout's 213.5 GB do not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCH_REGISTRY, get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.params import from_jax_params, param_bytes  # noqa: E402
from test_torch_encdec import numpy_params  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEW = ("whisper-large-v3", "internvl2-2b", "phi3-medium-14b",
       "stablelm-12b", "command-r-35b")
PROMPT, CACHE, STEPS = 13, 24, 4


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


ALL = NEW + tuple(sorted(set(JAX_REGISTRY) - set(NEW)))


# the port's corrections of a recorded reference quirk (ROADMAP.md §3: the
# reference's smollm-360m config cites SmolLM-135M)
QUIRKS = {("smollm-360m", "citation")}


def _value(v):
    """A field's value, a sub-config (MoEConfig, SSMConfig: one class in
    each package) as its fields."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_config_equals_the_reference(name, reduced):
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        if (name, f.name) in QUIRKS:
            continue
        assert _value(getattr(tcfg, f.name)) == \
            _value(getattr(jcfg, f.name)), f.name
    assert sorted(ARCH_REGISTRY) == sorted(JAX_REGISTRY)


@pytest.mark.parametrize("name", ALL)
def test_optimized_config_equals_the_reference(name):
    jcfg, tcfg = jax_get_arch(name).optimized(), get_arch(name).optimized()
    for f in dataclasses.fields(tcfg):
        if (name, f.name) in QUIRKS:
            continue
        assert _value(getattr(tcfg, f.name)) == \
            _value(getattr(jcfg, f.name)), f.name
    for prop in ("is_subquadratic", "supports_decode"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert tcfg.supports_shape(shape) == jcfg.supports_shape(shape)


def _dense_case(name, head_dim):
    jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    if head_dim:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        tcfg = dataclasses.replace(tcfg, head_dim=head_dim)
    return jcfg, tcfg


@pytest.mark.parametrize("name,head_dim", [
    ("phi3-medium-14b", 0), ("stablelm-12b", 0), ("command-r-35b", 0),
    ("stablelm-12b", 160)])
def test_reduced_prefill_and_decode_match_jax(name, head_dim):
    """stablelm's LayerNorm and untied head, command-r's LayerNorm
    without bias; at head_dim 160 the q/k/v projections are 640 wide."""
    jcfg, tcfg = _dense_case(name, head_dim)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    npp = numpy_params(tm.param_specs(), 5)
    jp, tp = jax.tree.map(jnp.asarray, npp), from_jax_params(npp)
    assert tp["layers"]["attn"]["wq"].shape[-1] == tcfg.head_dim
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, PROMPT)).astype(np.int32)
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)},
                           cache_len=CACHE)
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)},
                           cache_len=CACHE)
    assert _err(jl, tl) <= TOL["bfloat16"]
    for n in ("k", "v"):
        assert _err(jc["attn"][n], tc["attn"][n]) <= TOL["bfloat16"]
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(STEPS):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(PROMPT + step))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), PROMPT + step)
        assert _err(jl, tl) <= TOL["bfloat16"], step
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


def _qkv(rng, dtype, *shapes):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (40, 40, True, 0), (40, 40, True, 16), (5, 70, False, 0)])
def test_plain_k11_at_e160_matches_jax_reference(Sq, Sk, causal, window,
                                                 dtype):
    """The reduced stablelm at head_dim 160: 4 heads over 2 KV heads."""
    _, tcfg = _dense_case("stablelm-12b", 160)
    H, KV, E = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    (jq, jk, jv), (tq, tk, tv) = _qkv(np.random.default_rng(Sq + Sk),
                                      dtype, (2, Sq, H, E), (2, Sk, KV, E),
                                      (2, Sk, KV, E))
    want = JR.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(want, got) <= TOL[dtype]


def test_k11_plan_and_head_dims_at_e160():
    """stablelm's prefill of 1000 tokens (32 heads over 8, M = 4): 256
    items of 128 rows; E = 160 never takes 192 or 64 rows."""
    assert 160 in FA.HEAD_DIMS and FA.item_rows(160) == (128,)
    assert FA.plan(1, 1000, 8, 4, 160, 132) == FA.Plan(128, 32, 256)
    assert FA.plan(1, 4, 8, 4, 160, 132) == FA.Plan(128, 1, 8)
    assert FA.item_rows(128) == (128, 64)
    assert FA.item_rows(64) == FA.ITEM_ROWS


def test_weights_fit_one_card():
    cr = build_model(get_arch("command-r-35b"))
    assert param_bytes(cr.param_specs()) == 60_571_058_176
    TS.require_weights_fit(cr, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not fit"):
        TS.require_weights_fit(build_model(get_arch(
            "llama4-scout-17b-a16e")), torch.device("cpu"))
