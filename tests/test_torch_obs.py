"""The port's observability layer (``repro_torch.obs`` and
``repro_torch.launch.obsreport``) held against the JAX package's.

The numpy-only modules are the port's own copies: each equals its
original once ``repro`` is read as ``repro_torch``.  The reference's
properties (``tests/test_obs.py``: deterministic snapshot order, kind
safety, the no-op sinks, span nesting, the ring bound, the JSONL and
Chrome exporters and the schema validator, the compile/steady split, the
CostModel fit, the ``slo.Recorder``-as-view fold, obsreport's span
attribution and its exit 1 on an invalid trace) run on both packages,
and ``fit_cost_model`` agrees between them on seeded pairs.
"""
import importlib
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ["repro", "repro_torch"]
COPIES = ["obs/__init__.py", "obs/metrics.py", "obs/trace.py",
          "serving/__init__.py", "serving/admission.py",
          "serving/workload.py", "serving/slo.py", "serving/loop.py",
          "serving/capacity.py", "launch/obsreport.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_the_original_after_renaming(path):
    theirs = (ROOT / "src" / "repro" / path).read_text(encoding="utf-8")
    ours = (ROOT / "src" / "repro_torch" / path).read_text(encoding="utf-8")
    assert ours == re.sub(r"\brepro\b", "repro_torch", theirs)


@pytest.fixture(params=PKGS)
def O(request):
    """One package's ``obs``, reset to the no-op sinks around the test."""
    mod = importlib.import_module(f"{request.param}.obs")
    mod.reset()
    yield mod
    mod.reset()


def _pkg(O):
    return O.__name__.split(".")[0]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_instruments_basic(O):
    reg = O.MetricsRegistry()
    c = reg.counter("bytes", strategy="hring")
    c.inc(10)
    c.inc(5)
    assert c.value == 15
    g = reg.gauge("occ")
    g.set(3)
    g.set(7)
    assert g.value == 7
    h = reg.histogram("lat")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    f = h.fields()
    assert f["count"] == 4 and f["total"] == 10.0 and f["mean"] == 2.5
    assert f["min"] == 1.0 and f["max"] == 4.0
    assert f["p50"] == 2.0 and f["p99"] == 4.0


def test_nearest_rank_convention(O):
    vals = list(range(1, 11))
    assert O.nearest_rank(vals, 50) == 5
    assert O.nearest_rank(vals, 95) == 10
    assert math.isnan(O.nearest_rank([], 50))


def test_same_name_same_tags_same_instrument_and_kind_safety(O):
    reg = O.MetricsRegistry()
    assert reg.counter("x", a=1) is reg.counter("x", a=1)
    assert reg.counter("x", a=1) is not reg.counter("x", a=2)
    assert len(reg) == 2
    with pytest.raises(TypeError):
        reg.gauge("x", a=1)
    with pytest.raises(TypeError):
        reg.histogram("x", a=2)


def test_snapshot_order_independent_of_registration(O):
    a, b = O.MetricsRegistry(), O.MetricsRegistry()
    a.counter("z").inc(1)
    a.gauge("a", k="2").set(5)
    a.gauge("a", k="1").set(4)
    b.gauge("a", k="1").set(4)
    b.counter("z").inc(1)
    b.gauge("a", k="2").set(5)
    sa, sb = a.snapshot(), b.snapshot()
    assert sa == sb
    assert [r["name"] for r in sa] == ["a", "a", "z"]
    assert [r["tags"] for r in sa[:2]] == [{"k": "1"}, {"k": "2"}]


def test_null_registry_and_recorder_noop(O):
    reg = O.NullRegistry()
    assert reg.counter("x") is O.NOOP
    assert reg.gauge("x") is O.NOOP
    assert reg.histogram("x", wall=True) is O.NOOP
    O.NOOP.inc()
    O.NOOP.set(3)
    O.NOOP.observe(1)
    assert reg.snapshot() == []
    rec = O.NullRecorder()
    rec.event("x")
    rec.add_span("y", 0.0, 1.0)
    with rec.span("z"):
        pass
    assert len(rec) == 0


# ---------------------------------------------------------------------------
# flight recorder and exporters
# ---------------------------------------------------------------------------

def test_span_nesting_parent_ids(O):
    rec = O.FlightRecorder()
    with rec.span("outer", step=1):
        with rec.span("inner"):
            pass
        rec.event("mark", x=2)
    evs = rec.events
    assert [e["name"] for e in evs] == ["inner", "mark", "outer"]
    outer, inner = evs[2], evs[0]
    assert outer["parent"] == 0 and inner["parent"] == outer["id"]
    assert outer["attrs"] == {"step": 1}
    assert outer["seq"] < inner["seq"] < evs[1]["seq"]
    assert outer["dur"] >= inner["dur"] >= 0


def test_ring_bounding_and_n_dropped(O):
    rec = O.FlightRecorder(maxlen=10)
    for k in range(25):
        rec.event("e", k=k)
    assert len(rec) == 10 and rec.n_dropped == 15
    assert [e["attrs"]["k"] for e in rec.events] == list(range(15, 25))
    rec.clear()
    assert len(rec) == 0 and rec.n_dropped == 0


def test_metric_record_renames_instrument_kind(O):
    rec = O.FlightRecorder()
    rec.metric({"name": "lat", "kind": "histogram", "tags": {},
                "wall": False, "count": 3})
    (ev,) = rec.events
    assert ev["kind"] == "metric" and ev["instrument"] == "histogram"
    assert O.validate_events([ev]) == []


def _sample_events(O):
    rec = O.FlightRecorder(clock=iter(range(100)).__next__)
    with rec.span("step", k=1):
        rec.event("mark", v=2.5)
    rec.add_span("jit", 0.5, 0.25, wall=True, phase="compile")
    rec.metric({"name": "loss", "kind": "histogram", "tags": {},
                "wall": False, "count": 1, "mean": 3.0})
    rec.metric({"name": "svc", "kind": "histogram", "tags": {},
                "wall": True, "count": 1, "mean": 0.1})
    return rec.events


def test_jsonl_roundtrip_and_deterministic_export(O, tmp_path):
    evs = _sample_events(O)
    path = tmp_path / "t.jsonl"
    assert O.write_jsonl(evs, str(path)) == len(evs)
    assert O.read_jsonl(str(path)) == json.loads(json.dumps(evs))
    det = tmp_path / "d.jsonl"
    O.write_jsonl(evs, str(det), deterministic=True)
    out = O.read_jsonl(str(det))
    assert len(out) == len(evs) - 2          # the wall span and metric
    for ev in out:
        assert "ts" not in ev and "dur" not in ev and not ev.get("wall")
    assert O.validate_events(out) == []


def test_both_packages_write_the_same_bytes(tmp_path):
    """The same events through either package's exporters: the same
    JSONL, deterministic or not, and the same Chrome trace."""
    outs = []
    for pkg in PKGS:
        O = importlib.import_module(f"{pkg}.obs")
        evs = _sample_events(O)
        a, b = tmp_path / f"{pkg}.jsonl", tmp_path / f"{pkg}_d.jsonl"
        O.write_jsonl(evs, str(a))
        O.write_jsonl(evs, str(b), deterministic=True)
        outs.append((a.read_bytes(), b.read_bytes(),
                     json.dumps(O.chrome_trace(evs))))
    assert outs[0] == outs[1]


def test_validate_events_catches_violations(O):
    bad = [
        {"kind": "event", "name": "x"},
        {"seq": 1, "kind": "bogus", "name": "x"},
        {"seq": 1, "kind": "event", "name": ""},
        {"seq": 2, "kind": "span", "name": "s", "dur": -1.0, "id": "nope"},
        {"seq": 3, "kind": "event", "name": "y", "attrs": {"a": [1, 2]}},
    ]
    problems = O.validate_events(bad)
    for frag in ("seq", "kind", "duplicate", "name", "negative",
                 "id not int", "not a JSON scalar"):
        assert any(frag in p for p in problems), (frag, problems)
    assert O.validate_events(_sample_events(O)) == []


def test_chrome_trace_schema(O):
    doc = O.chrome_trace(_sample_events(O))
    assert doc["displayTimeUnit"] == "ms"
    phases = [e["ph"] for e in doc["traceEvents"]]
    assert phases.count("X") == 2 and "i" in phases
    assert phases.count("C") == 2
    jit = next(e for e in doc["traceEvents"] if e["name"] == "jit")
    assert jit["ts"] == pytest.approx(0.5e6)
    assert jit["dur"] == pytest.approx(0.25e6)
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# ProfiledFn and fit_cost_model
# ---------------------------------------------------------------------------

def test_profiled_fn_compile_steady_split(O):
    reg, rec = O.MetricsRegistry(), O.FlightRecorder()
    fn = O.ProfiledFn(lambda x: x.sum(), "f", metrics=reg, recorder=rec)
    a8, a16 = np.zeros(8), np.zeros(16)
    fn(a8)
    fn(a8)
    fn(a8)
    fn(a16)
    assert fn.n_calls == 4 and fn.n_compiles == 2
    assert fn.steady_mean_s == pytest.approx(fn.steady_s / 2)
    by_phase = {r["tags"]["phase"]: r for r in reg.snapshot()
                if r["name"] == "profile/call_s"}
    assert by_phase["compile"]["count"] == 2
    assert by_phase["steady"]["count"] == 2
    assert all(r["wall"] for r in by_phase.values())
    spans = [e for e in rec.events if e["kind"] == "span"]
    assert len(spans) == 4 and all(e.get("wall") for e in spans)
    assert O.profiled(fn, "f") is fn
    key = O.ProfiledFn(lambda d: 0, "g", key=lambda a, kw: len(a[0]))
    key({"a": 1})
    key({"b": 2})
    assert key.n_compiles == 1 and key.n_calls == 2


def test_port_profiled_fn_keys_torch_tensors():
    """The port's wrapper keys on torch shapes and dtypes and, on the
    CPU, runs no synchronization."""
    import torch

    from repro_torch.obs import ProfiledFn

    fn = ProfiledFn(lambda x: x + 1, "f")
    fn(torch.zeros(3))
    fn(torch.ones(3))
    fn(torch.zeros(3, dtype=torch.bfloat16))
    assert fn.n_compiles == 2 and fn.n_calls == 3


def test_fit_cost_model(O):
    base, slope = 0.010, 0.002
    wave = [(w, base + slope * w) for w in (1, 2, 3, 4, 5)] * 3
    fit = O.fit_cost_model(wave, admit_obs=[0.02, 0.04])
    assert fit["wave_base_s"] == pytest.approx(base, abs=1e-12)
    assert fit["per_work_s"] == pytest.approx(slope, abs=1e-12)
    assert fit["admit_s"] == pytest.approx(0.03)
    assert fit["n_waves"] == 15 and fit["resid_s"] < 1e-12
    fit = O.fit_cost_model([(3, 0.02), (3, 0.04)])
    assert fit["per_work_s"] == 0.0
    assert fit["wave_base_s"] == pytest.approx(0.03)
    empty = O.fit_cost_model([])
    assert math.isnan(empty["wave_base_s"]) and empty["n_waves"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_cost_model_equal_between_packages(seed):
    rng = np.random.default_rng(seed)
    work = rng.integers(0, 40, size=50)
    secs = 0.004 + 1.5e-4 * work + rng.normal(0, 5e-4, size=50)
    pairs = list(zip(work.tolist(), secs.tolist()))
    admits = rng.uniform(0.003, 0.02, size=7).tolist()
    fits = [importlib.import_module(f"{p}.obs").fit_cost_model(pairs, admits)
            for p in PKGS]
    assert fits[0] == fits[1]


# ---------------------------------------------------------------------------
# the module-level sinks, and slo.Recorder as a view
# ---------------------------------------------------------------------------

def test_configure_reset_dispatch(O, tmp_path):
    assert not O.enabled()
    O.event("ignored")
    with O.span("ignored"):
        pass
    assert O.dump(str(tmp_path / "x.jsonl")) == 0
    assert not (tmp_path / "x.jsonl").exists()
    O.configure()
    assert O.enabled()
    O.counter("c").inc(2)
    O.event("e", k=1)
    with O.span("s"):
        pass
    path, chrome = tmp_path / "t.jsonl", tmp_path / "t_chrome.json"
    n = O.dump(str(path), chrome=str(chrome))
    evs = O.read_jsonl(str(path))
    assert n == len(evs) == 3
    assert O.validate_events(evs) == []
    assert json.loads(chrome.read_text())["traceEvents"]
    O.reset()
    assert not O.enabled() and O.counter("c") is O.NOOP


def test_recorder_fold_equals_live_table(O):
    slo = importlib.import_module(f"{_pkg(O)}.serving.slo")
    O.configure()
    live = slo.Recorder()
    live.offered(1, 0, 0.0, deadline=5.0)
    live.offered(2, 1, 0.5)
    live.admitted(1, 0.6)
    live.first_token(1, 0.7)
    live.preempted(1)
    live.admitted(1, 0.9)
    live.done(1, 1.2, n_tokens=4)
    live.rejected(2, 0.8, reason="pool_full")
    folded = slo.fold_request_events(O.get_recorder().events)
    assert folded.events == live.events
    assert folded.n_preemptions == live.n_preemptions == 1
    assert slo.summarize(folded) == slo.summarize(live)
    with pytest.raises(KeyError):
        slo.fold_request_events([{"seq": 1, "kind": "event",
                                  "name": "request/done",
                                  "attrs": {"rid": 99, "now": 1.0}}])


def test_slo_csv_shims(O):
    slo = importlib.import_module(f"{_pkg(O)}.serving.slo")
    assert slo.CSV_HEADER is O.CSV_HEADER
    assert slo.csv_row is O.csv_row and slo.print_csv_rows is O.print_csv_rows
    assert O.csv_row("a", 1.5, "d") == "a,1.5,d"
    assert O.csv_row("a", "raw") == "a,raw,"


# ---------------------------------------------------------------------------
# obsreport
# ---------------------------------------------------------------------------

def test_obsreport_span_attribution_and_rows(O):
    rep = importlib.import_module(f"{_pkg(O)}.launch.obsreport")
    rec = O.FlightRecorder(clock=iter(range(100)).__next__)
    with rec.span("outer"):
        with rec.span("inner"):
            pass
    rows = {name: (n, tot, slf)
            for name, n, tot, slf in rep.span_table(rec.events)}
    assert rows["inner"] == (1, 1.0, 1.0)
    assert rows["outer"] == (1, 3.0, 2.0)
    rec.add_span("train/step", 0.0, 2.0, wall=True, phase="compile")
    rec.add_span("train/step", 2.0, 0.5, wall=True, phase="steady")
    prof = rep.compile_steady(rec.events)
    assert prof["train/step"]["compile"] == [1, 2.0]
    assert prof["train/step"]["steady"] == [1, 0.5]
    prof2 = rep.compile_steady([
        {"seq": 1, "kind": "metric", "name": "profile/call_s",
         "tags": {"fn": "f", "phase": "steady"}, "count": 4, "total": 2.0}])
    assert prof2["f"]["steady"] == [4, 2.0]
    names = [r[0] for r in rep.report_rows(rec.events)]
    assert "trace/events" in names and "span/outer" in names
    assert "profile/train/step/compile_s" in names


def test_obsreport_cli_rejects_invalid(O, tmp_path, capsys):
    rep = importlib.import_module(f"{_pkg(O)}.launch.obsreport")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"seq": 1, "kind": "bogus", "name": "x"}\n')
    assert rep.main([str(bad)]) == 1
    assert "schema problem" in capsys.readouterr().err
    good = tmp_path / "good.jsonl"
    O.write_jsonl(_sample_events(O), str(good))
    assert rep.main([str(good), "--csv"]) == 0
    chrome = tmp_path / "c.json"
    assert rep.main([str(good), "--chrome", str(chrome)]) == 0
    assert json.loads(chrome.read_text())["traceEvents"]
