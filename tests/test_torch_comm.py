"""The port's communication substrate held against the JAX package on the
CPU: the mixing matrices and mixers (``core/mixing.py``), the int8
quantizer and its ring shim (``core/compression.py``), the wire codecs
and every non-elastic ``Transport`` configuration (``core/transport.py``).

The arithmetic is elementwise IEEE in the reference's order (the means
over learners and pods sum in index order and scale by f32(1/n), as
``jnp.mean`` compiles), so mixed replicas, the error-feedback residual
and estimate, and ``wire_bytes`` are held bit for bit over three rounds;
only ``mix_matrix`` (an f32 matrix product) is held at 1e-6 normalised.
The JAX side runs eagerly, op by op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import transport as ttr  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

MATRIX_TOL = 1e-6
BUCKET = 64          # 16 f32 elements a bucket: splits "w" and "v" below


def _params(L, seed):
    """Three leaves: bf16 (45 elements a learner: 3 buckets), f32 (13: one
    bucket) and f32 (120: 8 buckets)."""
    rng = np.random.default_rng(seed)
    return {"w": jnp.asarray(rng.normal(size=(L, 9, 5)), jnp.bfloat16),
            "b": jnp.asarray(rng.normal(size=(L, 13)), jnp.float32),
            "v": jnp.asarray(rng.normal(size=(L, 3, 40)), jnp.float32)}


def _tree(tree):
    return from_jax_params({k: _np(v) if not isinstance(v, dict)
                            else {k2: _np(v2) for k2, v2 in v.items()}
                            for k, v in tree.items()})


def _np(a):
    return np.asarray(a)


def _assert_bits(want, got, where):
    """Every leaf of the port's tree carries the JAX leaf's bits and
    dtype."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            _assert_bits(want[k], got[k], f"{where}/{k}")
        return
    ref = _tree({"a": want})["a"]
    assert got.dtype == ref.dtype, where
    assert got.shape == ref.shape, where
    assert torch.equal(got.view(torch.uint8) if got.dtype != torch.bfloat16
                       else got.view(torch.int16),
                       ref.view(torch.uint8) if ref.dtype != torch.bfloat16
                       else ref.view(torch.int16)), where


def _nudge(tree, seed):
    """The same small update on both sides between rounds (numpy), so the
    error-feedback state sees new differences every round."""
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray(np.asarray(v, np.float32)
                           + 0.05 * rng.normal(size=v.shape), v.dtype)
            for k, v in tree.items()}


def _configs():
    out = []
    for L in (1, 2, 4):
        for wire in ttr.WIRES:
            for bucket in (0, BUCKET):
                for topo in ("none", "ring", "uniform", "exp"):
                    out.append((L, topo, 1, wire, "f32", bucket))
                pods = sorted({1, 2, L} - ({2} if L % 2 else set()))
                for pod in pods:
                    for intra in (("f32",) if pod == 1
                                  else ("f32", "bf16", "int8")):
                        out.append((L, "hierarchical", pod, wire, intra,
                                    bucket))
    return out


def _id(c):
    L, topo, pod, wire, intra, bucket = c
    return f"L{L}-{topo}{pod if topo == 'hierarchical' else ''}-{wire}" \
           f"-intra_{intra}-b{bucket}"


@pytest.mark.parametrize("cfg", _configs(), ids=_id)
def test_transport_matches_jax_over_three_rounds(cfg):
    L, topo, pod, wire, intra, bucket = cfg
    kw = dict(topology=topo, wire=wire, intra_wire=intra,
              bucket_bytes=bucket, pod_size=pod, topk_frac=0.2)
    jt, tt = jtr.Transport(**kw), ttr.Transport(**kw)
    assert tt.needs_state == jt.needs_state
    assert tt.resolved_gamma == jt.resolved_gamma
    p = _params(L, seed=L)
    assert tt.wire_bytes(_tree(p)) == jt.wire_bytes(p)
    jcomm = jt.init_comm(p)
    tcomm = tt.init_comm(_tree(p))
    _assert_bits(jcomm, tcomm, "init_comm")
    jmixer, tmixer = jt.make_mixer(L), tt.make_mixer(L)
    for r in range(3):
        tp = _tree(p)
        want, jcomm = jmixer(p, jnp.int32(r), jcomm)
        got, tcomm = tmixer(tp, r, tcomm)
        _assert_bits(want, got, f"round {r} params")
        _assert_bits(jcomm, tcomm, f"round {r} comm")
        p = _nudge(want, seed=10 * L + r)


@pytest.mark.parametrize("wire", ttr.WIRES)
@pytest.mark.parametrize("bucket", [0, BUCKET])
def test_decode_payload_and_coded_buckets_bit_equal(wire, bucket):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 100)).astype(np.float32)
    x[1, :] = 0.0                          # int8: a zero sender, scale 1
    x[2, :10] = 1.5                        # topk: ties at the threshold
    x[3, 7] = -3.0
    jt = jtr.Transport(wire=wire, bucket_bytes=bucket, topk_frac=0.05)
    tt = ttr.Transport(wire=wire, bucket_bytes=bucket, topk_frac=0.05)
    want = np.asarray(jtr._coded(jt, wire, jnp.asarray(x)))
    got = ttr._coded(tt, wire, torch.from_numpy(x)).numpy()
    assert want.tobytes() == got.tobytes()
    assert ttr._bucket_sizes(100, bucket) == jtr._bucket_sizes(100, bucket)
    for n in (1, 7, 100, 12345):
        for frac in (0.01, 0.2, 1.0):
            assert ttr._topk_k(n, frac) == jtr._topk_k(n, frac)


def test_int8_error_within_half_a_scale_and_topk_keeps_ties():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 500)).astype(np.float32))
    d = ttr.decode_payload("int8", x)
    scale = x.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((d - x).abs() <= scale / 2).all())
    y = torch.tensor([[1.0, -2.0, 2.0, 0.5, 2.0, 0.1]])
    kept = ttr.decode_payload("topk", y, topk_frac=0.3)     # k = 2
    assert kept.tolist() == [[0.0, -2.0, 2.0, 0.0, 2.0, 0.0]]


@pytest.mark.parametrize("topo", ["ring", "uniform", "exp"])
@pytest.mark.parametrize("wire", ttr.WIRES)
def test_mean_preservation_across_wires(topo, wire):
    """The reference's ``test_mean_preservation_across_wires`` on the
    port: doubly-stochastic mixing keeps the replica mean within the
    codec's error, and the difference-coded topk gossip exactly (to f32
    rounding)."""
    rng = np.random.default_rng(4)
    w = {"a": torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))}
    mu = w["a"].mean(0)
    t = ttr.Transport(topology=topo, wire=wire, topk_frac=0.25)
    mixed, _ = t.make_mixer(8)(w, 0, t.init_comm(w))
    drift = float((mixed["a"].mean(0) - mu).abs().max())
    tol = {"f32": 1e-6, "bf16": 2e-2, "int8": 2e-2, "topk": 1e-5}[wire]
    assert drift < tol, drift


@pytest.mark.parametrize("L,pod", [(1, 1), (2, 1), (2, 2), (4, 2), (6, 3),
                                   (8, 2), (8, 4), (16, 4)])
def test_hierarchical_matrix_and_mixer(L, pod):
    T = tmix.hierarchical_matrix(L, pod)
    np.testing.assert_array_equal(T, jmix.hierarchical_matrix(L, pod))
    assert tmix.is_doubly_stochastic(T)
    np.testing.assert_array_equal(tmix.identity_matrix(L),
                                  jmix.identity_matrix(L))
    p = _params(L, seed=L + 20)
    _assert_bits(jmix.mix_hierarchical(p, pod_size=pod),
                 tmix.mix_hierarchical(_tree(p), pod_size=pod), "mix")
    # the collective form is the matrix (f64 against the f32 mixer)
    w = _tree(p)["v"].double().reshape(L, -1)
    want = torch.from_numpy(T) @ w
    got = tmix.mix_hierarchical(_tree(p), pod_size=pod)["v"].reshape(L, -1)
    assert float((got.double() - want).abs().max()) <= \
        MATRIX_TOL * float(want.abs().max())
    with pytest.raises(ValueError, match="pod_size"):
        tmix.hierarchical_matrix(L, L + 1)


@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_exp_mixer_bit_equal_and_exact_consensus(L):
    m = max(int(np.log2(L)), 1)
    jexp, texp = jmix.make_exp_mixer(L), tmix.make_exp_mixer(L)
    p = _params(L, seed=30 + L)
    for step in range(2 * m + 1):
        _assert_bits(jexp(p, jnp.int32(step)), texp(_tree(p), step),
                     f"step {step}")
    # log2 L rounds from step 0 reach consensus (f32: to rounding)
    q = {"v": _tree(p)["v"]}
    for step in range(m):
        q = texp(q, step)
    rms = float(torch.sqrt(torch.mean(torch.square(_tree(p)["v"]))))
    assert float(TS.consensus_distance(q)) <= 1e-6 * rms
    if L > 2:
        with pytest.raises(ValueError, match="power-of-2"):
            tmix.make_exp_mixer(L - 1)


@pytest.mark.parametrize("L", [2, 3, 5])
def test_mix_matrix_matches_jax(L):
    rng = np.random.default_rng(L)
    T = rng.random((L, L))
    T = T / T.sum(1, keepdims=True)
    p = _params(L, seed=40 + L)
    want = jmix.mix_matrix(p, T)
    got = tmix.mix_matrix(_tree(p), T)
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert got[k].dtype == _tree(p)[k].dtype
        err = np.abs(g - w).max() / np.abs(w).max()
        # the bf16 leaf: one rounding of the f32 product apart at most
        tol = MATRIX_TOL if want[k].dtype == jnp.float32 else 2 ** -8
        assert err <= tol, (k, err)


@pytest.mark.parametrize("kind", ["ring", "uniform", "none", "ring_q8",
                                  "exp"])
@pytest.mark.parametrize("L", [2, 4])
def test_get_mixer_matches_jax(kind, L):
    p = _params(L, seed=50 + L)
    for step in range(3):
        want = jmix.get_mixer(kind, L)(p, jnp.int32(step))
        got = tmix.get_mixer(kind, L)(_tree(p), step)
        _assert_bits(want, got, f"{kind} step {step}")
    assert set(tmix.MIXERS) == set(jmix.MIXERS)


@pytest.mark.parametrize("shape", [(17,), (4, 33), (2, 3, 5)])
def test_quantize_int8_and_ring_shim_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tcomp.dequantize_int8(tq, ts).numpy().tobytes() == \
        np.asarray(jcomp.dequantize_int8(jq, js)).tobytes()
    zq, zs = tcomp.quantize_int8(torch.zeros(shape))
    assert float(zs) == 1.0 and not zq.any()
    p = _params(4, seed=60)
    _assert_bits(jcomp.mix_ring_q8(p), tcomp.mix_ring_q8(_tree(p)), "q8")
    assert tcomp.make_exp_mixer is tmix.make_exp_mixer
