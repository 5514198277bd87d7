"""The port's BLSTM (plain layer and model forward) held against the JAX
package on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages; weights cross through ``repro_torch.params.from_jax_params``.
Tolerance: bf16 forward 2e-2 after normalising by the oracle's max-abs
(docs/kernels.md §Oracle tolerances).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels import lstm_cell as jlc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import lstm_cell as tlc  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402

B, T, D, H = 3, 7, 12, 16
BF16_TOL = 2e-2


def _norm_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-8
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"normalised max error {err:.3g} > {tol}"


def _t(a):
    """numpy (incl. ml_dtypes bf16) -> torch, through the port's loader."""
    return from_jax_params({"a": np.asarray(a)})["a"]


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(D, 4 * H), w(H, 4 * H),
               jnp.asarray(rng.normal(size=(4 * H,)) * 0.1, jnp.float32)]
    x = w(B, T, D, scale=1.0)
    return ws, x


@pytest.mark.parametrize("lengths", [None, (7, 4, 1)])
def test_blstm_layer_matches_jax(lengths):
    ws, x = _layer_inputs(0)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want_ref = jref.blstm_ref(*ws, x, lengths=jl)
    want_pallas = jlc.blstm_sequence(*ws, x, jl, interpret=True)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = tlc.blstm_layer(*(_t(w) for w in ws), _t(x), tl)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, 2 * H)
    got = got.float().numpy()
    _norm_close(got, np.asarray(want_ref, np.float32), BF16_TOL)
    _norm_close(got, np.asarray(want_pallas, np.float32), BF16_TOL)
    if lengths is not None:                     # padded steps are zero
        for b, n in enumerate(lengths):
            assert not got[b, n:].any()


def test_full_lengths_equal_unmasked():
    """Masking with lengths == T reduces to the rectangular layer."""
    ws, x = _layer_inputs(1)
    args = [_t(w) for w in ws] + [_t(x)]
    full = torch.full((B,), T, dtype=torch.int32)
    assert torch.equal(tlc.blstm_layer(*args), tlc.blstm_layer(*args, full))


def _reduced():
    return jax_get_arch("swb2000-blstm").reduced(), \
        get_arch("swb2000-blstm").reduced()


@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_forward_matches_jax(impl):
    jcfg, tcfg = _reduced()
    assert (tcfg.n_layers, tcfg.lstm_hidden, tcfg.vocab) == (2, 64, 512)
    params = init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 8, jcfg.input_dim)).astype(np.float32)
    lengths = np.asarray([8, 5], np.int32)
    want = jlstm.forward(jcfg, params, jnp.asarray(feats),
                         jnp.asarray(lengths), kernel_impl=impl)
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    got = tlstm.forward(tcfg, tparams, torch.from_numpy(feats),
                        torch.from_numpy(lengths), device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    _norm_close(got.numpy(), np.asarray(want), BF16_TOL)


def test_init_params_mirrors_jax_specs():
    """Same tree, shapes and dtypes as the reference's init; lecun/normal
    scales drawn as ``sharding.init_param`` draws them."""
    jcfg, tcfg = _reduced()
    jtree = jax.tree.map(np.asarray, init_spec_tree(
        jlstm.param_specs(jcfg), jax.random.PRNGKey(0)))
    ttree = init_params(tlstm.param_specs(tcfg), seed=0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for path, leaf in jflat:
        keys = [p.key for p in path]
        t = ttree
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, keys
    wx = ttree["layers"]["layer_0"]["fwd"]["wx"].float()
    assert abs(wx.std().item() - tcfg.input_dim ** -0.5) < 0.1 * \
        tcfg.input_dim ** -0.5
    assert abs(ttree["softmax_w"].float().std().item() - 0.02) < 0.002
    assert not ttree["softmax_b"].any()
    again = init_params(tlstm.param_specs(tcfg), seed=0, device="cpu")
    assert torch.equal(again["bottleneck"], ttree["bottleneck"])


def test_from_jax_params_carries_bits():
    ws, _ = _layer_inputs(3)
    got = _t(ws[0])
    assert got.dtype == torch.bfloat16
    want = np.asarray(ws[0]).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_sequence_mask_matches_jax():
    from repro.models.common import sequence_mask as jax_mask
    from repro_torch.models.common import sequence_mask

    lengths = np.asarray([0, 3, 7, 9], np.int32)
    got = sequence_mask(torch.from_numpy(lengths), 8)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_mask(jnp.asarray(lengths),
                                                      8)))


def test_reduced_config_mirrors_jax_fields():
    jcfg, tcfg = _reduced()
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
