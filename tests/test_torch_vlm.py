"""The vlm family (``internvl2-2b``) in the port, held against the JAX
package on the CPU at the reduced width (2 layers, d 256, 4 heads over 2
KV heads, head_dim 64, vocab 512), and its serving contracts.

Weights are numpy draws on the port's specs (``test_torch_encdec.
numpy_params``) handed to both packages, patch embeddings and tokens
numpy draws too.  A prefill of patch embeddings then text tokens, its
cache, and 4 teacher-forced decode steps agree at the bf16 tolerance
(2e-2, normalised; docs/kernels.md §Oracle tolerances).  ``Server`` and
``PagedServer`` serve the family with token prompts, as the reference's
do, under the dense LM servers' contracts (``tests/test_torch_lm_serve.
py``): batched ≡ sequential, paged ≡ dense, prefix-shared ≡ unshared,
preempt/restore ≡ uninterrupted, typed rejections, the CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving.admission import (NO_BUDGET, POOL_FULL,  # noqa: E402
                                           PROMPT_TOO_LONG)
from test_torch_encdec import numpy_params  # noqa: E402

BF16_TOL = 2e-2
ARCH = "internvl2-2b"
B, PATCHES, TEXT, CACHE, STEPS = 2, 12, 9, 32, 4


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    npp = numpy_params(tm.param_specs(), 3)
    jp, tp = jax.tree.map(jnp.asarray, npp), from_jax_params(npp)
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos))
    return jcfg, tcfg, jm, tm, jp, tp, jdec


def test_family_is_attention_only_dense(models):
    tcfg, tm = models[1], models[3]
    assert tcfg.family == "vlm" and tcfg.frontend == "vision"
    assert "vlm" in TT.ATTENTION_ONLY and "vlm" in TT.PORTED_FAMILIES
    assert set(tm.param_specs()["layers"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(tm.page_specs(8, 4)) == {"attn"}


def test_prefill_with_patches_and_decode_match_jax(models):
    """The prefill over 12 patch embeddings then 9 text tokens: logits
    and the cache (its first 21 positions filled, the rest zero); then 4
    teacher-forced decode steps after both (positions 21..24)."""
    _, tcfg, jm, tm, jp, tp, jdec = models
    rng = np.random.default_rng(4)
    patches = rng.standard_normal((B, PATCHES, tcfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, tcfg.vocab, (B, TEXT)).astype(np.int32)
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                "patches": jnp.asarray(patches)},
                           cache_len=CACHE)
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                "patches": torch.from_numpy(patches)},
                           cache_len=CACHE)
    assert _err(jl, tl) <= BF16_TOL
    n = PATCHES + TEXT
    for name in ("k", "v"):
        assert _err(jc["attn"][name], tc["attn"][name]) <= BF16_TOL
        assert not tc["attn"][name][:, :, n:].any()
        assert tc["attn"][name][:, :, :PATCHES].any()
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(STEPS):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(n + step))
        tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(tok), n + step)
        assert _err(jl, tl) <= BF16_TOL, step
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    # without patches the prefill is the dense family's
    jl, _ = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, cache_len=16)
    tl, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)},
                          cache_len=16)
    assert _err(jl, tl) <= BF16_TOL


# ---------------------------------------------------------------------------
# serving: the dense LM servers' contracts on the vlm family
# ---------------------------------------------------------------------------

def _cfg():
    return get_arch(ARCH).reduced()


def _dense(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    return TS.Server(_cfg(), device="cpu", **kw)


def _paged(**kw):
    kw.setdefault("pool_pages", 12)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 16)
    return TS.PagedServer(_cfg(), device="cpu", **kw)


def _prompts(lengths, shared=0, seed=0):
    return [p for _, p in TS.lm_requests(_cfg(), lengths,
                                         shared_prefix=shared, seed=seed)]


def _serve(server, prompts, max_new):
    finished, _, _, _ = TS.serve_lm(server, list(enumerate(prompts)),
                                    max_new)
    return dict(finished)


def test_batched_equals_sequential_and_paged_equals_dense():
    prompts = _prompts([6, 6, 9])
    batched = _serve(_dense(slots=3, max_len=16), prompts, 4)
    sequential = _serve(_dense(slots=3, max_len=16, batched=False),
                        prompts, 4)
    paged = _serve(_paged(pool_pages=16), prompts, 4)
    assert batched == sequential == paged and len(batched) == 3
    assert all(len(t) == 4 for t in batched.values())


def test_prefix_shared_equals_unshared():
    prompts = _prompts([6, 6], shared=6, seed=1)
    shared = _paged()
    got = _serve(shared, prompts, 3)
    assert shared.pool.n_shared_hits > 0
    assert any(k == "cow" for k, _, _ in shared.events)
    assert got == _serve(_paged(share=False), prompts, 3)


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_restore_bit_exact(paged):
    prompts = _prompts([6, 9], seed=3)

    def run(preempt_at):
        s = _paged() if paged else _dense(slots=2)
        for rid, p in enumerate(prompts):
            assert s.admit(rid, p, 4)
        fin = []
        for i in range(30):
            if i == preempt_at:
                snap = s.preempt(0)
                fin += s.step()
                assert s.restore(snap)
            fin += s.step()
            if not s.active.any():
                break
        return dict(fin)

    base, pre = run(-1), run(1)
    assert base == pre and len(base) == 2


def test_typed_admission():
    s = _dense(slots=1, max_len=8)
    assert s.admit(0, np.arange(10), 4).reason == PROMPT_TOO_LONG
    assert s.admit(0, np.arange(3), 0).reason == NO_BUDGET
    assert s.admit(0, np.arange(3), 4)
    assert s.admit(1, np.arange(3), 4).reason == POOL_FULL
    p = _paged(pool_pages=3)
    assert p.admit(0, _prompts([14], seed=5)[0], 8).reason == NO_BUDGET
    assert p.admit(1, _prompts([9], seed=6)[0], 3)
    assert p.admit(2, _prompts([9], seed=7)[0], 3).reason == POOL_FULL


@pytest.mark.parametrize("extra", [[], ["--cache", "paged", "--page-size",
                                        "4", "--shared-prefix", "6"]])
def test_cli_serves_vlm_on_cpu(capsys, extra):
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
             "3", "--slots", "2", "--prompt-len", "8", "--max-len", "16",
             "--max-new", "4", *extra])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 12 tokens" in out
    if extra:
        assert "[kv] pool=8 pages x 4 positions" in out
