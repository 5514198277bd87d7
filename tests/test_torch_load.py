"""The port's serve-under-load launcher (``repro_torch.launch.load``) held
against ``repro.launch.load`` on the CPU at the reduced width.

Both launchers serve the same seeded overload (30 requests/s for one
virtual second onto 2 slots, two priority tiers, patience 0.4 s) through
the same admission controller and cost model, in virtual time, with
``--trace-out --trace-deterministic``.  Every CSV row must be equal, and
the deterministic traces line for line apart from the ``kernel/*`` gauge
lines, whose names and values are the port's own (its kernels' shared
memory, not the TPU's VMEM).  The timeline depends only on the trace,
the cost model, admission outcomes and the servers' work, so the LM rows
hold at any weights; the ASR ``tokens`` row sums hypothesis lengths, so
the port's ASR server serves JAX's weights (``from_jax_params``).  The
JAX launcher runs once per mode (module fixture).
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.launch import load as JL  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import load as TL  # noqa: E402
from repro_torch.launch.obsreport import main as report  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

LOAD = ["--qps", "30", "--horizon", "1", "--len-median", "8",
        "--len-sigma", "0.1", "--patience", "0.4"]
MODES = {
    "dense": ["--arch", "smollm-360m"],
    "paged": ["--arch", "smollm-360m", "--cache", "paged", "--page-size",
              "4"],
    "asr": ["--arch", "swb2000-blstm"],
}


def _run(main, argv, path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv + ["--trace-out", str(path),
                          "--trace-deterministic"])
    return rc, out.getvalue().splitlines()


def _csv(lines):
    return [ln for ln in lines if ln.count(",") >= 2]


def _outside_kernel(path):
    lines = path.read_text().splitlines()
    return [ln for ln in lines
            if not json.loads(ln)["name"].startswith("kernel/")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mode -> (JAX's lines and trace, the port's lines and trace)."""
    tmp = tmp_path_factory.mktemp("load")
    out = {}
    for mode, argv in MODES.items():
        held = {}
        build = JL.build_server

        def keep(cfg, args):
            server, kind = build(cfg, args)
            held["params"] = jax.tree.map(np.asarray, server.params)
            return server, kind

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JL, "build_server", keep)
            jrc, jlines = _run(JL.main, argv + LOAD, tmp / f"{mode}_j.jsonl")
        jobs.reset()
        tbuild = TL.build_server

        def with_jax_weights(cfg, args, device):
            server, kind = tbuild(cfg, args, device)
            if kind == "asr":
                server.params = from_jax_params(held["params"])
            return server, kind

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TL, "build_server", with_jax_weights)
            trc, tlines = _run(TL.main, argv + LOAD + ["--reduced",
                                                       "--device", "cpu"],
                               tmp / f"{mode}_t.jsonl")
        obs.reset()
        assert jrc == 0 and trc == 0
        out[mode] = (jlines, tmp / f"{mode}_j.jsonl", tlines,
                     tmp / f"{mode}_t.jsonl")
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_csv_rows_equal_jax(runs, mode):
    jlines, _, tlines, _ = runs[mode]
    want, got = _csv(jlines), _csv(tlines)
    assert got == want
    rows = {ln.split(",")[0]: float(ln.split(",")[1]) for ln in got[1:]}
    # an overload: tiers preempt and every offered request ends somewhere
    assert rows["load/offered"] == rows["load/done"] + \
        rows["load/abandoned"] + rows["load/rejected"]
    assert rows["load/offered"] > 10


@pytest.mark.parametrize("mode", list(MODES))
def test_deterministic_trace_equal_jax_outside_kernel_gauges(runs, mode):
    _, jpath, _, tpath = runs[mode]
    want, got = _outside_kernel(jpath), _outside_kernel(tpath)
    assert got == want and len(got) > 50
    names = {json.loads(ln)["name"] for ln in got}
    assert {"request/offered", "request/done", "serve/admit",
            "serve/done"} <= names


def test_overload_preempts_lm(runs):
    for mode in ("dense", "paged"):
        rows = dict(ln.split(",")[:2] for ln in _csv(runs[mode][2])[1:])
        assert float(rows["load/preemptions"]) > 0, mode


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_gauges_are_the_ports(runs, mode):
    """The port's ``kernel/*`` gauges: the shared memory its own kernels
    take (K5, K7, K8), never a VMEM size."""
    _, _, _, tpath = runs[mode]
    gauges = {json.loads(ln)["name"]: json.loads(ln)
              for ln in tpath.read_text().splitlines()
              if json.loads(ln)["name"].startswith("kernel/")}
    want = {"dense": {"kernel/decode_attn_smem_bytes"},
            "paged": {"kernel/paged_attn_smem_bytes"},
            "asr": {"kernel/beam_smem_bytes", "kernel/beam_cand_bytes"}}
    assert set(gauges) == want[mode]
    for g in gauges.values():
        assert g["instrument"] == "gauge" and 0 < g["value"] <= 232448 \
            or g["name"] == "kernel/beam_cand_bytes"
    if mode == "asr":     # the reference's formula, copied
        jg = [json.loads(ln) for ln in runs[mode][1].read_text().splitlines()
              if json.loads(ln)["name"] == "kernel/beam_cand_bytes"]
        assert gauges["kernel/beam_cand_bytes"]["value"] == jg[0]["value"]


def test_ports_trace_renders(runs, capsys):
    for mode in MODES:
        assert report([str(runs[mode][3])]) == 0
    assert "requests (folded from request/* events)" in capsys.readouterr().out


def test_wall_calibrate_rows(tmp_path):
    """``--wall`` on the CPU: the calibration rows and the wall-marked
    service-time histograms (dropped from a deterministic export)."""
    out = io.StringIO()
    path = tmp_path / "w.jsonl"
    with contextlib.redirect_stdout(out):
        rc = TL.main(["--arch", "smollm-360m", "--reduced", "--device",
                      "cpu", "--qps", "20", "--horizon", "0.2", "--wall",
                      "--trace-out", str(path)])
    obs.reset()
    assert rc == 0
    rows = dict(ln.split(",")[:2] for ln in _csv(out.getvalue().split("\n")))
    for name in ("calib/admit_ms", "calib/wave_ms", "calib/work_us",
                 "calib/n_waves", "calib/resid_ms"):
        assert name in rows
    assert float(rows["calib/n_waves"]) > 0
    evs = obs.read_jsonl(str(path))
    assert obs.validate_events(evs) == []
    hist = {e["name"] for e in evs if e["kind"] == "metric" and e["wall"]}
    assert {"load/admit_s", "load/wave_s", "profile/call_s"} <= hist


def test_refuses_without_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.main(["--arch", "smollm-360m", "--reduced"])
    assert not obs.enabled()
