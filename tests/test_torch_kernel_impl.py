"""Which side a kernel wrapper takes, the public wrappers, and K10's
learner-fold cache, on the CPU.

* ``plain_path``: a CPU tensor and a fake tensor (the dry-run's, on any
  device) take the plain version; a tensor on any other device takes the
  kernel path, whose device check raises off the card (a meta tensor
  here): nothing falls back from the kernel path to the plain one.
* ``kernels/ops`` names the port's wrappers; ``ops.blstm_stack`` under a
  gradient equals the per-layer ``blstm_sequence`` chain.
* ``long_context`` reaches ``layer_windows`` from ``prefill_fn``.
* The train CLI's ``--mesh pod|multipod`` raise, naming their devices;
  the reference's ``--kernel-impl`` is no flag of the port's CLIs.
* ``fold_experts`` reuses a kept fold only while the weights are
  unchanged: an in-place update of a leaf gives a fresh fold.
"""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.device import plain_path  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import lstm_cell as LC  # noqa: E402
from repro_torch.kernels import moe_dense as MD  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import evaluate as EV  # noqa: E402
from repro_torch.launch import load as LD  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.params import init_params  # noqa: E402


@pytest.fixture(scope="module")
def smollm():
    cfg = get_arch("smollm-360m").reduced()
    model = build_model(cfg)
    return cfg, model, init_params(model.param_specs(), 0, "cpu")


@pytest.mark.parametrize("kind,plain", [("cpu", True), ("fake-cpu", True),
                                        ("fake-cuda", True),
                                        ("meta", False)])
def test_plain_path_takes_cpu_and_fake_tensors_only(kind, plain):
    if kind.startswith("fake"):
        with FakeTensorMode():
            t = torch.empty(2, 3, device=kind[5:])
    else:
        t = torch.empty(2, 3, device=kind)
    assert plain_path(t) is plain


def test_a_wrapper_on_a_meta_tensor_raises_instead_of_running_plain():
    q = torch.empty(1, 4, 2, 64, dtype=torch.bfloat16, device="meta")
    n = FA.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention(q, q, q)
    assert FA.launches == n


def test_ops_are_the_wrappers_and_the_stack_chains_layers():
    assert ops.attention is FA.flash_attention
    assert ops.lstm_sequence is LC.lstm_sequence
    assert ops.blstm_sequence is LC.blstm_sequence
    assert ops.ssd is SSD.ssd
    assert ops.moe_dense is MD.moe_dense
    g = torch.Generator().manual_seed(4)

    def w(*s):
        return (torch.randn(*s, generator=g) * 0.3).to(torch.bfloat16)
    layers = [(w(8, 32), w(8, 32), torch.zeros(32), w(8, 32), w(8, 32),
               torch.zeros(32)), (w(16, 32), w(8, 32), torch.zeros(32),
                                  w(16, 32), w(8, 32), torch.zeros(32))]
    x = w(2, 5, 8)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    want = LC.blstm_stack(layers, x, lens)
    assert torch.equal(ops.blstm_stack(layers, x, lens), want)
    grads = [[t.clone().requires_grad_() for t in ws] for ws in layers]
    y = ops.blstm_stack(grads, x, lens)
    assert y.shape == want.shape and y.requires_grad
    chain = x[None]
    for ws in grads:
        chain = LC.blstm_sequence(*(t[None] for t in ws), chain, lens[None])
    assert torch.equal(y, chain[0])


@pytest.mark.parametrize("cli", [TT, SV, EV, LD])
def test_the_clis_take_no_kernel_impl(cli, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    usage = capsys.readouterr().out
    assert "--device" in usage and "--kernel-impl" not in usage


def test_long_context_reaches_the_windows(smollm, monkeypatch):
    cfg, model, params = smollm
    seen = []
    real = TF.layer_windows

    def spy(cfg, seq_len, *, long_context=False):
        seen.append(long_context)
        return real(cfg, seq_len, long_context=long_context)
    monkeypatch.setattr(TF, "layer_windows", spy)
    tokens = torch.zeros(1, 4, dtype=torch.long)
    logits, cache = model.prefill_fn(params, {"tokens": tokens},
                                     long_context=True)
    model.decode_fn(params, cache, tokens[:, :1], 3, long_context=True)
    assert seen == [True, True]
    assert real(cfg, 16, long_context=True)[0] == cfg.window_for_long


@pytest.mark.parametrize("mesh,n", [("pod", 256), ("multipod", 512)])
def test_train_cli_refuses_the_pod_meshes(mesh, n):
    with pytest.raises(ValueError, match=f"{n} devices"):
        TT.main(["--reduced", "--device", "cpu", "--steps", "1", "--mesh",
                 mesh])
    TT.check_mesh("local")


def test_fold_is_fresh_after_an_in_place_update():
    """The kept fold of learner-stacked (non-contiguous) expert weights
    is reused while they are unchanged, and refolded after ``add_``."""
    g = torch.Generator().manual_seed(0)
    base = [torch.randn(2, 3, 4, 5, 6, generator=g).to(torch.bfloat16)
            for _ in range(3)]
    wi, wg, wo = (b[:, 1] for b in base)     # a strided layer slice
    assert not wi.is_contiguous()
    keep = {}
    first = MD.fold_experts(wi, wg, wo, keep, 0)
    again = MD.fold_experts(wi, wg, wo, keep, 0)
    assert all(a is b for a, b in zip(first, again))
    wi.add_(1.0)                             # an in-place update
    fresh = MD.fold_experts(wi, wg, wo, keep, 0)
    want = wi.contiguous().flatten(0, 1)
    assert torch.equal(fresh[0], want)
    assert not torch.equal(first[0], want)
    assert fresh[0] is not first[0]
    assert MD.fold_experts(wi, wg, wo, keep, 0)[0] is fresh[0]
