"""``--trace-out`` / ``--trace-deterministic`` on the port's train, serve
and evaluate CLIs, on the CPU at the reduced width.

A traced run gives the results of an untraced one (the train state bit
for bit, the served tokens, the evaluate metrics); its trace passes the
schema validator; both packages' ``obsreport`` render it to the same
text; and two seeded runs with ``--trace-deterministic`` write the same
bytes.
"""
import contextlib
import importlib
import io

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.launch import evaluate as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402

TRAIN = ["--reduced", "--device", "cpu", "--learners", "2", "--steps", "2",
         "--log-every", "1", "--var-len"]
SERVE = {
    "dense": ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--max-new", "5"],
    "paged": ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--max-new", "5",
              "--cache", "paged", "--page-size", "4", "--shared-prefix",
              "6"],
    "asr": ["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--beam-width", "4"],
}


@pytest.fixture(autouse=True)
def _no_op_sinks():
    obs.reset()
    yield
    obs.reset()


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(argv)
    assert not obs.enabled()          # every CLI resets what it configured
    return ret, out.getvalue()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _renders(path):
    """The trace is valid, and both packages' obsreport print the same
    text and the same CSV for it."""
    evs = obs.read_jsonl(str(path))
    assert evs and obs.validate_events(evs) == []
    texts = []
    for pkg in ("repro", "repro_torch"):
        rep = importlib.import_module(f"{pkg}.launch.obsreport")
        texts.append([_quiet(rep.main, [str(path)]),
                      _quiet(rep.main, [str(path), "--csv"])])
    assert texts[0] == texts[1]
    assert texts[1][0][0] == 0
    return evs, texts[1][0][1]


def test_train_trace_keeps_the_results(tmp_path):
    plain, _ = _quiet(TT.main, TRAIN)
    path = tmp_path / "t.jsonl"
    traced, out = _quiet(TT.main, TRAIN + ["--trace-out", str(path)])
    a, b = dict(_leaves(plain["state"])), dict(_leaves(traced["state"]))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert [r[3] for r in plain["records"]] == \
        [r[3] for r in traced["records"]]
    evs, text = _renders(path)
    steps = [e for e in evs
             if e["kind"] == "event" and e["name"] == "train/step"]
    assert [e["attrs"]["step"] for e in steps] == [0, 1]
    assert {"loss", "grad_norm", "wire_bytes"} <= set(steps[0]["attrs"])
    assert float(plain["metrics"]["loss"]) == steps[-1]["attrs"]["loss"]
    names = {e["name"] for e in evs}
    assert {"train/fetch", "train/step", "kernel/stash_bytes",
            "train/loss", "train/grad_norm", "train/wire_bytes",
            "train/pad_eff", "profile/call_s"} <= names
    assert "train/step" in text and "compile" in text


def test_train_trace_run_twice_bit_equal(tmp_path):
    traces = []
    for k in (1, 2):
        path = tmp_path / f"t{k}.jsonl"
        _quiet(TT.main, TRAIN + ["--trace-out", str(path),
                                 "--trace-deterministic"])
        traces.append(path.read_bytes())
    assert traces[0] == traces[1]
    evs, text = _renders(tmp_path / "t1.jsonl")
    assert all("ts" not in e and "dur" not in e for e in evs)
    assert "dropped by the deterministic export" in text


def _served(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("  req ")]


@pytest.mark.parametrize("mode", list(SERVE))
def test_serve_trace_keeps_the_results(tmp_path, mode):
    _, plain = _quiet(TS.main, SERVE[mode])
    path = tmp_path / "s.jsonl"
    _, traced = _quiet(TS.main, SERVE[mode] + ["--trace-out", str(path)])
    assert _served(plain) == _served(traced) and len(_served(plain)) == 3
    entry = "serve/fwd" if mode == "asr" else "serve/prefill"
    assert f"timing: {entry} compile" in traced
    evs, text = _renders(path)
    names = {e["name"] for e in evs}
    assert {"serve/admit", "serve/done", "serve/wave", entry} <= names
    gauge = {"dense": "kernel/decode_attn_smem_bytes",
             "paged": "kernel/paged_attn_smem_bytes",
             "asr": "kernel/beam_smem_bytes"}[mode]
    assert gauge in names and gauge in text


@pytest.mark.parametrize("mode", ["dense", "asr"])
def test_serve_trace_run_twice_bit_equal(tmp_path, mode):
    traces = []
    for k in (1, 2):
        path = tmp_path / f"s{k}.jsonl"
        _quiet(TS.main, SERVE[mode] + ["--trace-out", str(path),
                                       "--trace-deterministic"])
        traces.append(path.read_bytes())
    assert traces[0] == traces[1]
    _renders(tmp_path / "s1.jsonl")


def test_evaluate_trace_keeps_the_results(tmp_path):
    ck = str(tmp_path / "ck")
    _quiet(TT.main, ["--reduced", "--device", "cpu", "--steps", "1",
                     "--log-every", "0", "--ckpt-dir", ck,
                     "--ckpt-every", "1"])
    argv = ["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
            "--ckpt-dir", ck, "--batches", "2", "--seq-len", "8",
            "--var-len", "--decode-chunk", "4"]
    plain, _ = _quiet(TE.main, argv)
    path = tmp_path / "e.jsonl"
    traced, _ = _quiet(TE.main, argv + ["--trace-out", str(path)])
    for key in ("fer", "ter_greedy", "ter_beam", "valid_frames",
                "beam_occupancy"):
        assert plain[key] == traced[key], key
    evs, _ = _renders(path)
    spans = [e["name"] for e in evs if e["kind"] == "span"]
    # a warm-up batch (one padded shape) and two timed ones
    assert spans.count("eval/fwd") == 3 and spans.count("eval/decode") == 3
    hists = {e["name"] for e in evs if e["kind"] == "metric"}
    assert {"eval/fwd_s", "eval/decode_s"} <= hists
    det = tmp_path / "d.jsonl"
    _quiet(TE.main, argv + ["--trace-out", str(det),
                            "--trace-deterministic"])
    assert det.read_text() == ""          # every record was wall-clock
