"""The port's fused BLSTM stack (``blstm_stack``, the K4 port, on the CPU
its plain version ``blstm_stack_plain``) held against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its fused-stack Pallas kernel in interpret mode.
Tolerances:

* against JAX (``blstm_stack_sequence`` in interpret mode and
  ``ref.blstm_stack_ref``): bf16 forward 2e-2 after normalising by the
  oracle's max-abs (docs/kernels.md §Oracle tolerances).  Bit identity
  with JAX stops at one rounding: XLA's CPU ``tanh`` and ``logistic``
  sit 1-2 ulp from PyTorch's (ROADMAP.md queue 3);
* within the port, the stack is bit-identical to the loop of
  ``blstm_layer`` (the reference's contract for its fused stack,
  ``lstm_cell.py:1318-1320``);
* the reduced model's no-grad forward: 2e-2 of JAX's
  ``kernel_impl="pallas"`` forward, which runs K4 at H = 64.
"""
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
from repro_torch.kernels.ref import blstm_stack_plain  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

B, T, D0, H, L = 5, 9, 12, 16, 3          # tests/test_longseq.py:186
LENGTHS = (9, 2, 7, 1, 5)
BF16_TOL = 2e-2


def _norm_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-8)


def _t(a):
    """numpy (incl. ml_dtypes bf16) -> torch, through the port's loader."""
    return from_jax_params({"a": np.asarray(a)})["a"]


def _stack_inputs(seed, n_layers=L, d0=D0, h=H, b=B):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)

    layers = []
    for k in range(n_layers):
        d = d0 if k == 0 else 2 * h
        ws = []
        for _ in range(2):
            ws += [w(d, 4 * h), w(h, 4 * h),
                   jnp.asarray(rng.normal(size=(4 * h,)) * 0.1, jnp.float32)]
        layers.append(tuple(ws))
    return tuple(layers), w(b, T, d0, scale=1.0)


def _torch_layers(layers):
    return [[_t(w) for w in ws] for ws in layers]


@pytest.mark.parametrize("masked", [False, True])
def test_blstm_stack_matches_jax(masked):
    layers, x = _stack_inputs(0)
    jl = jnp.asarray(LENGTHS, jnp.int32) if masked else None
    fused = jlc.blstm_stack_sequence(layers, x, jl, interpret=True,
                                     block_b=2)
    want_ref = jref.blstm_stack_ref(layers, x, jl)
    tl = torch.tensor(LENGTHS, dtype=torch.int32) if masked else None
    got = tlc.blstm_stack(_torch_layers(layers), _t(x), tl)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, 2 * H)
    got = got.float().numpy()
    assert _norm_err(got, fused) <= BF16_TOL
    assert _norm_err(got, want_ref) <= BF16_TOL
    if masked:                                  # padded steps are zero
        for b, n in enumerate(LENGTHS):
            assert not got[b, n:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_blstm_stack_bit_identical_to_layer_loop(masked):
    layers, x = _stack_inputs(1)
    tl = torch.tensor(LENGTHS, dtype=torch.int32) if masked else None
    tls, tx = _torch_layers(layers), _t(x)
    loop = tx
    for ws in tls:
        loop = tlc.blstm_layer(*ws, loop, tl)
    got = tlc.blstm_stack(tls, tx, tl)
    assert torch.equal(got, loop)
    assert torch.equal(got, blstm_stack_plain(tls, tx, tl))


def test_blstm_stack_learner_axis_equals_each_learner():
    """A leading learner axis on x, every weight and the lengths stacks
    independent models."""
    stacks = [_stack_inputs(s) for s in (2, 3)]
    tl = torch.tensor([LENGTHS, LENGTHS[::-1]], dtype=torch.int32)
    per = [tlc.blstm_stack(_torch_layers(ls), _t(x), tl[i])
           for i, (ls, x) in enumerate(stacks)]
    stacked = [[torch.stack([_t(stacks[0][0][k][j]), _t(stacks[1][0][k][j])])
                for j in range(6)] for k in range(L)]
    x2 = torch.stack([_t(stacks[0][1]), _t(stacks[1][1])])
    got = tlc.blstm_stack(stacked, x2, tl)
    assert torch.equal(got, torch.stack(per))


def test_blstm_stack_leaves_the_launch_count_on_cpu():
    layers, x = _stack_inputs(4, n_layers=2)
    before = (tlc.stack_launches, tlc.launches)
    tlc.blstm_stack(_torch_layers(layers), _t(x))
    assert (tlc.stack_launches, tlc.launches) == before


def test_forward_no_grad_matches_jax_fused_stack():
    """The reduced model's inference forward (the stack on the card, its
    plain version here) against JAX's ``kernel_impl="pallas"`` forward,
    whose ``_stack_primal`` takes the fused kernel at this width."""
    jcfg, tcfg = (jax_get_arch("swb2000-blstm").reduced(),
                  get_arch("swb2000-blstm").reduced())
    feats_shape = (2, 8, jcfg.input_dim)
    itemsize = 2
    bb = jlc.auto_stack_block_b(feats_shape[0], feats_shape[1],
                                jcfg.input_dim, jcfg.lstm_hidden, itemsize)
    assert jlc._stack_usage(bb, feats_shape[1], jcfg.input_dim,
                            jcfg.lstm_hidden, itemsize) \
        <= jlc.DEFAULT_VMEM_BUDGET            # the fused path, not the loop
    params = init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    feats = rng.normal(size=feats_shape).astype(np.float32)
    lengths = np.asarray([8, 3], np.int32)
    want = jlstm.forward(jcfg, params, jnp.asarray(feats),
                         jnp.asarray(lengths), kernel_impl="pallas")
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tlstm.forward(tcfg, tparams, torch.from_numpy(feats),
                            torch.from_numpy(lengths), device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _norm_err(got.numpy(), want) <= BF16_TOL
    # the inference branch is the stack: equal to its plain version
    plain = tlstm.forward(tcfg, tparams, torch.from_numpy(feats),
                          torch.from_numpy(lengths), device="cpu",
                          plain=True)
    assert torch.equal(got, plain)
