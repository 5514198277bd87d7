"""The plain versions of the port's chunked SSD scan (the K9 port's
``ref.ssd_plain`` and the exact recurrence ``ref.ssd_ref``) and the CPU
path of its wrapper ``kernels.ssd_scan.ssd``, held against the JAX
package on the CPU: the Pallas kernel in interpret mode and
``repro.kernels.ref.ssd_ref``.

Tolerances: both chunked versions compute in f32 and round y once, so y
agrees within one bf16 rounding (2^-8 of the output scale) and the f32
state within 1e-5 normalised.  Against the exact recurrence, which sums
in another order, the state holds at 1e-5 and y at one bf16 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ssd_scan import ssd as jax_ssd  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as TS  # noqa: E402

BF16_ULP = 2.0 ** -8       # one bf16 rounding, relative to the output scale
F32_TOL = 1e-5


def _inputs(B, S, H, P, N, seed, dtype=np.float32, G=None):
    """x, dt (softplus of a normal), A (negative), B/C per group, as numpy;
    x, B and C rounded to bf16 when ``dtype`` is bf16."""
    rng = np.random.default_rng(seed)
    G = G or H
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    if dtype == "bfloat16":
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16))
                     for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16"
        else torch.float32) for a in arrays]


def _err(want, got):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 16, 8, 32),
    (1, 64, 2, 32, 16, 16),
    (1, 256, 8, 64, 64, 64),
])
def test_ssd_plain_matches_jax_pallas_interpret(B, S, H, P, N, chunk):
    """The shapes of tests/test_kernels.py::test_ssd_kernel, bf16 inputs."""
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=S + H, dtype="bfloat16")
    jy, jh = jax_ssd(*_jax(x, dt, A, Bm, Cm), chunk=chunk, interpret=True)
    ty, th = TR.ssd_plain(*_torch(x, dt, A, Bm, Cm), chunk=chunk)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == jy.shape
    assert th.dtype == torch.float32 and tuple(th.shape) == jh.shape
    assert _err(jy, ty) <= BF16_ULP
    assert _err(jh, th) <= F32_TOL


def test_ssd_ref_matches_jax_ssd_ref():
    x, dt, A, Bm, Cm = _inputs(2, 24, 3, 8, 4, seed=1)
    jy, jh = JR.ssd_ref(*_jax(x, dt, A, Bm, Cm))
    ty, th = TR.ssd_ref(*_torch(x, dt, A, Bm, Cm))
    assert _err(jy, ty) <= F32_TOL
    assert _err(jh, th) <= F32_TOL


@pytest.mark.parametrize("S,chunk", [(40, 16), (7, 16), (16, 16), (33, 8)])
def test_ssd_plain_matches_jax_ssd_ref_any_length(S, chunk):
    """A ragged last chunk (S = 40, Q = 16) and S < Q: the plain chunked
    version equals the exact recurrence of the JAX package."""
    x, dt, A, Bm, Cm = _inputs(2, S, 3, 16, 8, seed=S, dtype="bfloat16")
    jy, jh = JR.ssd_ref(*_jax(x, dt, A, Bm, Cm))
    ty, th = TR.ssd_plain(*_torch(x, dt, A, Bm, Cm), chunk=chunk)
    assert _err(jy, ty) <= BF16_ULP
    assert _err(jh, th) <= F32_TOL


def test_fault1_jax_pallas_refuses_ragged_length_port_accepts():
    """The reference's Pallas SSD asserts S % Q == 0, so a 40-token prompt
    at chunk 16 cannot be served; the port's wrapper serves it and agrees
    with the exact recurrence."""
    x, dt, A, Bm, Cm = _inputs(1, 40, 2, 16, 8, seed=7, dtype="bfloat16")
    with pytest.raises(AssertionError):
        jax_ssd(*_jax(x, dt, A, Bm, Cm), chunk=16, interpret=True)
    ty, th = TS.ssd(*_torch(x, dt, A, Bm, Cm), chunk=16)
    jy, jh = JR.ssd_ref(*_jax(x, dt, A, Bm, Cm))
    assert _err(jy, ty) <= BF16_ULP
    assert _err(jh, th) <= F32_TOL


@pytest.mark.parametrize("G", [1, 2])
def test_grouped_bc_equals_broadcast(G):
    """B/C per group (G < H) give what the broadcast (B, S, H, N) inputs
    give, bit for bit, in both plain versions."""
    H = 4
    x, dt, A, Bm, Cm = _inputs(2, 20, H, 16, 8, seed=3 + G, G=G)
    tx, tdt, tA, tB, tC = _torch(x, dt, A, Bm, Cm)
    rep = lambda a: a.repeat_interleave(H // G, dim=2)   # noqa: E731
    for fn in (lambda *a: TR.ssd_plain(*a, chunk=8), TR.ssd_ref):
        gy, gh = fn(tx, tdt, tA, tB, tC)
        by, bh = fn(tx, tdt, tA, rep(tB), rep(tC))
        assert torch.equal(gy, by) and torch.equal(gh, bh)
    # head h reads group h // (H // G), as jnp.repeat over the group axis
    want = np.repeat(Bm, H // G, axis=2)
    np.testing.assert_array_equal(TR.expand_groups(tB, H).numpy(), want)


def test_wrapper_runs_plain_on_cpu_and_checks_shapes():
    x, dt, A, Bm, Cm = _torch(*_inputs(1, 20, 2, 16, 8, seed=5))
    before = TS.launches
    y, h = TS.ssd(x, dt, A, Bm, Cm, chunk=8)
    py, ph = TR.ssd_plain(x, dt, A, Bm, Cm, chunk=8)
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert TS.launches == before           # the plain path counts nothing
    with pytest.raises(ValueError, match="groups"):
        TS.ssd(x, dt, A, torch.zeros(1, 20, 3, 8), torch.zeros(1, 20, 3, 8),
               chunk=8)
    with pytest.raises(ValueError, match="dt"):
        TS.ssd(x, dt[:, :5], A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="B/C"):
        TS.ssd(x, dt, A, Bm, Cm[:, :5], chunk=8)


def test_ssd_plain_state_is_finite_at_strong_decay():
    """A large dt * |A| would overflow exp of a masked (q < k) difference;
    the masked exponent keeps every output finite."""
    x, dt, A, Bm, Cm = _torch(*_inputs(1, 64, 2, 16, 8, seed=9))
    dt = dt * 200.0
    y, h = TR.ssd_plain(x, dt, A, Bm, Cm, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    ry, rh = TR.ssd_ref(x, dt, A, Bm, Cm)
    assert _err(ry.numpy(), y) <= 1e-4
