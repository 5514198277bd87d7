"""The K11 port's plain version and the repaired prefill attention, held
against the JAX package on the CPU.

``flash_attention_plain`` (the CPU path of the K11 wrapper and the card's
oracle) against ``repro.kernels.ref.attention_ref`` over the JAX kernel
test's own grid (MHA, GQA 3:1, MQA at E 128; window 0 and 64; bf16 and
f32; non-causal), plus what the port adds: ragged Sq, ``q_offset`` with
Sk > Sq, and the model's ``GLOBAL_WINDOW``.  Tolerances (normalised by
the reference's max-abs): f32 2e-5, bf16 2e-2 (one output rounding).

The port's ``attn_seq`` takes any Sq (a masked ragged last chunk): at Sq
= 600 it equals the reference's ``attn_seq(..., q_chunk=600)``, which
the reference accepts as one chunk (its default q_chunk 512 asserts).
Both LM servers at the reduced ``smollm-360m`` admit a 600-token prompt
and decode it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.transformer import GLOBAL_WINDOW  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _err(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


def _inputs(B, Sq, Sk, H, KV, E, dtype, seed):
    """The same values for both packages: numpy draws rounded once to
    ``dtype`` through JAX, handed to torch as f32 and cast back."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, E), (B, Sk, KV, E), (B, Sk, KV, E))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _check_plain(B, Sq, Sk, H, KV, E, dtype, *, causal=True, window=0,
                 q_offset=0, seed=0):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Sk, H, KV, E, dtype, seed)
    want = JR.attention_ref(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_offset)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(want, got) <= TOL[dtype]
    return tq, tk, tv, got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,H,KV,E", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 6, 2, 64),      # GQA 3:1
    (1, 256, 8, 1, 128),     # MQA, 128 head_dim
])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_matches_jax_reference(B, S, H, KV, E, dtype, window):
    _check_plain(B, S, S, H, KV, E, dtype, window=window, seed=S + H)


def test_plain_noncausal_matches_jax_reference():
    _check_plain(2, 128, 128, 4, 4, 64, "bfloat16", causal=False, seed=4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sq,window", [(1, 0), (100, 0), (100, 64),
                                        (600, 0), (600, 64)])
def test_plain_ragged_sq_matches_jax_reference(Sq, window, dtype):
    """Prompt lengths that are no multiple of any block (the Pallas kernel
    asserts Sq % block_q == 0), GQA groups of 5 as in hymba-1.5b."""
    _check_plain(1, Sq, Sq, 10, 2, 64, dtype, window=window, seed=Sq)


@pytest.mark.parametrize("window", [0, 48])
def test_plain_q_offset_matches_jax_reference(window):
    """A chunk of 37 queries at positions 90..126 against 127 keys."""
    _check_plain(2, 37, 127, 6, 2, 64, "float32", window=window, q_offset=90,
                 seed=7)


def test_global_window_is_full_attention():
    tq, tk, tv, full = _check_plain(1, 70, 70, 4, 2, 64, "float32", seed=8)
    glob = flash_attention_plain(tq, tk, tv, window=int(GLOBAL_WINDOW))
    assert torch.equal(glob, full)
    assert FA.kernel_window(GLOBAL_WINDOW, causal=True, q_offset=0,
                            Sq=70) == 0
    assert FA.kernel_window(69, causal=True, q_offset=0, Sq=70) == 69
    assert FA.kernel_window(70, causal=True, q_offset=0, Sq=70) == 0
    assert FA.kernel_window(None, causal=True, q_offset=0, Sq=70) == 0
    assert FA.kernel_window(16, causal=False, q_offset=0, Sq=70) == 0


def test_wrapper_runs_the_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any other
    device reaches the kernel's checks, never the plain path."""
    _, (tq, tk, tv) = _inputs(1, 20, 20, 4, 2, 64, "bfloat16", 9)
    before = FA.launches
    got = FA.flash_attention(tq, tk, tv, window=8)
    assert torch.equal(got, flash_attention_plain(tq, tk, tv, window=8))
    assert FA.launches == before

    def meta(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16, device="meta")

    q, kv = meta(1, 20, 4, 64), meta(1, 20, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim 48"):
        FA.flash_attention(meta(1, 20, 4, 48), meta(1, 20, 2, 48),
                           meta(1, 20, 2, 48))
    with pytest.raises(ValueError, match="multiple of KV"):
        FA.flash_attention(meta(1, 20, 5, 64), kv, kv)
    with pytest.raises(ValueError, match="admits no key"):
        FA.flash_attention(q, meta(1, 4, 2, 64), meta(1, 4, 2, 64),
                           window=8, q_offset=10)
    assert FA.launches == before


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_seq_ragged_chunk_matches_jax(dtype, window):
    """Sq = 600: the port chunks it 512 + 88 (masked ragged chunk), the
    reference takes it as one chunk of 600; at 512 the reference's
    default asserts ``(600, 512)``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 600, 600, 6, 2, 64, dtype, 10)
    with pytest.raises(AssertionError):
        JA.attn_seq(jq, jk, jv, causal=True, window=window)
    want = JA.attn_seq(jq, jk, jv, causal=True, window=window, q_chunk=600)
    got = TA.attn_seq(tq, tk, tv, causal=True, window=window)
    assert _err(want, got) <= TOL[dtype]
    one = TA.attn_seq(tq, tk, tv, causal=True, window=window, q_chunk=600)
    assert torch.equal(got, one)          # chunking changes no value
    assert torch.equal(TA.attn_prefill(tq, tk, tv, window=window), got)


def _smollm():
    return get_arch("smollm-360m").reduced()


@pytest.mark.parametrize("paged", [False, True])
def test_servers_admit_a_600_token_prompt(paged):
    """Both servers admit a 600-token prompt at max_len 1024 (before the
    repair, ``attn_seq`` raised ``AssertionError: (600, 512)``; the paged
    server from 513 tokens on, its prefill rounded up to whole pages) and
    decode it; the paged run decodes the dense run's tokens."""
    cfg = _smollm()
    pending = TS.lm_requests(cfg, [600, 37])

    def serve(server):
        finished, _, _, _ = TS.serve_lm(server, pending, 4)
        return dict(finished)

    dense = serve(TS.Server(cfg, slots=2, max_len=1024, device="cpu"))
    assert sorted(dense) == [0, 1]
    assert all(len(t) == 4 for t in dense.values())
    if paged:
        got = serve(TS.PagedServer(cfg, pool_pages=128, page_size=16,
                                   max_len=1024, device="cpu"))
        assert got == dense
