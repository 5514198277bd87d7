"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax``, the JAX package or ``msgpack``, and
its entry points refuse to run on the CPU unless asked to."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


def test_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.params\n"
        "import repro_torch.decode.kernel, repro_torch.kernels.lstm_cell\n"
        "import repro_torch.launch.train, repro_torch.core.strategies\n"
        "import repro_torch.core.mixing, repro_torch.core.transport\n"
        "import repro_torch.optim.optimizers, repro_torch.optim.schedules\n"
        "import repro_torch.models.transformer, repro_torch.models.api\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.serving.kvpool, repro_torch.configs.smollm_360m\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.configs.mamba2_370m\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs.hymba_1_5b\n"
        "import repro_torch.models.moe, repro_torch.kernels.moe_dense\n"
        "import repro_torch.configs.granite_moe_3b_a800m\n"
        "import repro_torch.configs.llama4_scout_17b_a16e\n"
        "import repro_torch.launch.evaluate, repro_torch.checkpoint\n"
        "import repro_torch.eval, repro_torch.obs\n"
        "import repro_torch.core.compression, repro_torch.models.ctc\n"
        "import repro_torch.decode.ref\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'msgpack')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.configs import get_arch
    from repro_torch.decode.beam import beam_search
    from repro_torch.launch.serve import AsrServer, main
    from repro_torch.models.lstm import forward, param_specs
    from repro_torch.params import init_params

    cfg = get_arch("swb2000-blstm").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsrServer(cfg, slots=1, max_frames=8, chunk=4)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward(cfg, params, np.zeros((1, 4, cfg.input_dim), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beam_search(np.zeros((1, 4, 5), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--reduced", "--requests", "1"])
    # explicitly asked for, the CPU works
    out = forward(cfg, params, np.zeros((1, 4, cfg.input_dim), np.float32),
                  device="cpu")
    assert out.shape == (1, 4, cfg.vocab)


def test_training_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main, setup_training

    cfg = get_arch("swb2000-blstm").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_training(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--reduced", "--steps", "1"])
    state, step, meta = setup_training(cfg, device="cpu")
    assert meta["device"] == torch.device("cpu")
    leaf = state["params"]["layers"]["layer_0"]["fwd"]["wx"]
    assert leaf.device.type == "cpu" and leaf.shape[0] == cfg.n_learners


def test_kernel_device_probe_rejects_cpu_tensors():
    from repro_torch.device import require_kernel_device, resolve_device

    with pytest.raises(ValueError, match="CUDA tensor"):
        require_kernel_device(torch.zeros(1))
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import PagedServer, Server, main

    cfg = get_arch("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServer(cfg, pool_pages=4, page_size=4, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "smollm-360m", "--reduced", "--requests", "1"])
    server = Server(cfg, slots=1, max_len=8, device="cpu")
    assert server.cache["attn"]["k"].device.type == "cpu"


def test_lm_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version; anything else must reach the
    kernel's device checks, never the plain path."""
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA

    q = torch.zeros(1, 1, 2, 8, dtype=torch.bfloat16)
    kc = torch.zeros(1, 4, 1, 8, dtype=torch.bfloat16)
    before = (DA.launches, DA.paged_launches, DK.argmax_launches)
    assert DA.decode_attention(q, kc, kc, 2).shape == q.shape
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    assert DA.paged_decode_attention(q, kc, kc, tbl, 2).shape == q.shape
    assert DK.argmax_tokens(torch.zeros(2, 5)).tolist() == [0, 0]
    assert (DA.launches, DA.paged_launches, DK.argmax_launches) == before
    meta = torch.zeros(1, 1, 2, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        DA.decode_attention(meta, kc, kc, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.argmax_tokens(torch.zeros(2, 5, device="meta"))


def test_moe_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import PagedServer, Server, main

    cfg = get_arch("granite-moe-3b-a800m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServer(cfg, pool_pages=4, page_size=4, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "granite-moe-3b-a800m", "--reduced", "--requests",
              "1"])
    server = Server(cfg, slots=1, max_len=8, device="cpu")
    assert server.params["layers"]["moe"]["wi"].device.type == "cpu"


def test_moe_kernel_wrapper_takes_the_plain_path_only_on_cpu():
    """K10's wrapper: a CPU tensor runs the plain version, anything else
    must reach the kernel's device checks, never the plain path."""
    from repro_torch.kernels import moe_dense as MD

    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 2)
    wi = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    before = MD.launches
    assert MD.moe_dense(x, w, wi, wi, wi).shape == x.shape
    assert MD.launches == before
    meta = [t.to("meta") for t in (x, w, wi)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        MD.moe_dense(meta[0], meta[1], meta[2], meta[2], meta[2])


def test_evaluate_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.launch import evaluate as TE
    from repro_torch.launch import train as TT
    from repro_torch.models.lstm import param_specs
    from repro_torch.params import init_params

    cfg = get_arch("swb2000-blstm").reduced()
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.main(["--arch", "swb2000-blstm", "--reduced", "--ckpt-dir", ck])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.restore_consensus(cfg, ckpt_dir=ck)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.evaluate_params(cfg, params, batches=1, batch=2, seq_len=4)
    # explicitly asked for, the CPU works
    TT.main(["--reduced", "--device", "cpu", "--steps", "1", "--log-every",
             "0", "--ckpt-dir", ck, "--ckpt-every", "1"])
    TE.main(["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
             "--ckpt-dir", ck, "--batches", "1", "--seq-len", "6"])


def test_stack_wrapper_takes_the_plain_path_only_on_cpu():
    """K4's wrapper: a CPU tensor runs the plain version, anything else
    must reach the kernel's device checks, never the plain path."""
    from repro_torch.kernels import lstm_cell as LC

    H, D = 8, 4
    layers = [[torch.zeros(d, 4 * H, dtype=torch.bfloat16),
               torch.zeros(H, 4 * H, dtype=torch.bfloat16),
               torch.zeros(4 * H)] * 2 for d in (D, 2 * H)]
    x = torch.zeros(2, 3, D, dtype=torch.bfloat16)
    before = LC.stack_launches
    assert LC.blstm_stack(layers, x).shape == (2, 3, 2 * H)
    assert LC.stack_launches == before
    meta = [[w.to("meta") for w in ws] for ws in layers]
    with pytest.raises(ValueError, match="CUDA tensor"):
        LC.blstm_stack(meta, x.to("meta"))
