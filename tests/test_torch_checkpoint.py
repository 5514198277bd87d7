"""The port's checkpoints (``repro_torch.checkpoint``): bit-exact round
trips of a train state, atomic saves, pruning, and validated restores,
with the reference's semantics (``repro.checkpoint.checkpoint``).

Everything here is exact: a restored leaf has the saved bits, dtype and
shape, or the restore raises naming the leaf.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as CK  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.train import setup_training  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _state(optimizer="momentum", learners=2, seed=0):
    cfg = get_arch("swb2000-blstm").reduced()
    state, _, _ = setup_training(cfg, strategy_name="ad_psgd",
                                 n_learners=learners,
                                 optimizer_name=optimizer, seed=seed,
                                 device="cpu")
    return state


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _perturbed(state, seed):
    """The state with every tensor leaf drawn anew (same dtypes), so a
    round trip cannot pass by restoring the init."""
    g = torch.Generator().manual_seed(seed)

    def draw(t):
        if isinstance(t, torch.Tensor):
            return torch.randn(t.shape, generator=g).to(t.dtype)
        return t
    return _map(draw, state)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("optimizer", ["momentum", "adam", "sgd"])
def test_round_trip_is_bit_exact(tmp_path, optimizer):
    state = _perturbed(_state(optimizer), 1)
    state["step"] = 7
    dtypes = {t.dtype for _, t in _leaves(state)
              if isinstance(t, torch.Tensor)}
    assert {torch.bfloat16, torch.float32} <= dtypes
    CK.save(str(tmp_path), 7, state)
    got, step = CK.restore(str(tmp_path), _state(optimizer))
    assert step == 7 and got["step"] == 7 and type(got["step"]) is int
    want = dict(_leaves(state))
    have = dict(_leaves(got))
    assert want.keys() == have.keys()
    for key, w in want.items():
        h = have[key]
        if isinstance(w, torch.Tensor):
            assert h.dtype == w.dtype and h.shape == w.shape, key
            assert _bits(h) == _bits(w), key
        else:
            assert h == w and type(h) is type(w), key
    assert list(state) == list(got)            # key order kept


def test_no_temporary_left_and_failed_save_keeps_previous(tmp_path,
                                                          monkeypatch):
    state = _state()
    CK.save(str(tmp_path), 1, state)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert sorted(os.listdir(tmp_path / "step_1")) == ["arrays.npz",
                                                       "tree.json"]

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        CK.save(str(tmp_path), 2, _perturbed(state, 3))
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert CK.latest_step(str(tmp_path)) == 1
    got, step = CK.restore(str(tmp_path), _state())
    assert step == 1
    w = state["params"]["softmax_w"]
    assert _bits(got["params"]["softmax_w"]) == _bits(w)


def test_prunes_to_keep(tmp_path):
    state = _state(learners=1, optimizer="sgd")
    for s in range(1, 6):
        CK.save(str(tmp_path), s, state, keep=3)
    assert sorted(CK.latest_steps(str(tmp_path))) == [3, 4, 5]
    assert CK.latest_step(str(tmp_path)) == 5
    _, step = CK.restore(str(tmp_path), state, step=4)
    assert step == 4


def test_learner_count_mismatch_names_the_leaf(tmp_path):
    CK.save(str(tmp_path), 2, _state(learners=2))
    with pytest.raises(ValueError, match=r"leaf .*\['bottleneck'\]\": "
                       r"saved shape \(2, 128, 32\) != expected \(3, "):
        CK.restore(str(tmp_path), _state(learners=3))


def test_dtype_mismatch_names_the_leaf(tmp_path):
    state = _state()
    CK.save(str(tmp_path), 2, state)
    like = _state()
    like["params"]["softmax_b"] = like["params"]["softmax_b"].double()
    with pytest.raises(ValueError,
                       match=r"\['params'\]\['softmax_b'\].*dtype"):
        CK.restore(str(tmp_path), like)


def test_structure_mismatch_raises(tmp_path):
    CK.save(str(tmp_path), 2, _state(optimizer="sgd"))
    with pytest.raises(ValueError, match="tree structure mismatch"):
        CK.restore(str(tmp_path), _state(optimizer="momentum"))


def test_empty_directory_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), _state())
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "missing"), _state())


def test_msgpack_is_not_imported():
    src = ROOT / "src" / "repro_torch" / "checkpoint" / "checkpoint.py"
    tree = ast.parse(src.read_text(encoding="utf-8"))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not any(m.split(".")[0] == "msgpack" for m in names), names
    code = ("import sys, repro_torch.checkpoint, repro_torch.launch.train\n"
            "import repro_torch.launch.evaluate\n"
            "sys.exit(1 if 'msgpack' in sys.modules else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_resume_is_bit_exact_with_an_uninterrupted_run(tmp_path):
    """The train CLI over a bucketed top-k wire (error-feedback state in
    ``state['comm']``) checkpointed at step 2 and resumed with
    ``--resume`` to step 4 ends bit-identical to 4 uninterrupted steps:
    params, prev_params, the momentum state and comm."""
    from repro_torch.launch.train import main

    base = ["--reduced", "--device", "cpu", "--strategy", "ad_psgd",
            "--optimizer", "momentum", "--var-len", "--log-every", "0",
            "--comm-wire", "topk", "--comm-topk-frac", "0.05",
            "--comm-bucket-mb", "1"]
    whole = main(base + ["--steps", "4"])["state"]
    ck = str(tmp_path / "ck")
    main(base + ["--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert CK.latest_step(ck) == 2
    resumed = main(base + ["--steps", "2", "--ckpt-dir", ck, "--resume"])
    resumed = resumed["state"]
    assert resumed["step"] == whole["step"] == 4
    assert {"params", "prev_params", "opt", "comm"} <= set(whole)
    want, have = dict(_leaves(whole)), dict(_leaves(resumed))
    assert want.keys() == have.keys()
    assert any(k.startswith("/comm/residual") for k in want)
    for key, w in want.items():
        if isinstance(w, torch.Tensor):
            assert _bits(have[key]) == _bits(w), key
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(base + ["--steps", "1", "--ckpt-dir", str(tmp_path / "none"),
                     "--resume"])
