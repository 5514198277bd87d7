"""The port's serving layer (``repro_torch.serving``: workload, SLO,
admission controller, loop, capacity) held against the JAX package's.

The reference's properties (``tests/test_serving.py``) run on both
packages over one in-memory server: seeded traces, exact diurnal
peak/trough rates, nearest-rank percentiles on hand-built traces, typed
rejections, tier order, preemption of the lowest-priority most recently
admitted victim, abandonment of unstarted requests only, no priority
inversion over whole virtual-time runs, the admit cost charged before
the first token, and the capacity bisection's exact midpoints.  Traces
and payloads of the two packages are equal for a few workloads (diurnal
ones among them), and the port's own servers run through the loop on
the CPU at the reduced width.
"""
import dataclasses
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ["repro", "repro_torch"]


def _serving(pkg):
    adm = importlib.import_module(f"{pkg}.serving.admission")
    return SimpleNamespace(
        S=importlib.import_module(f"{pkg}.serving"), adm=adm,
        cap=importlib.import_module(f"{pkg}.serving.capacity"),
        slo=importlib.import_module(f"{pkg}.serving.slo"),
        W=importlib.import_module(f"{pkg}.serving.workload"))


@pytest.fixture(params=PKGS)
def P(request):
    return _serving(request.param)


class FakeServer:
    """The slot-pool duck contract without a model: each request takes a
    fixed number of waves; payloads longer than ``too_long`` reject."""

    emits_on_admit = False

    def __init__(self, P, slots, waves=2, too_long=10_000):
        self.P = P
        self.slots = slots
        self.waves = waves
        self.too_long = too_long
        self.jobs = {}

    def submit(self, req, payload):
        a = self.P.adm
        if req.length > self.too_long:
            return a.AdmitResult(a.PROMPT_TOO_LONG)
        if req.max_new <= 0:
            return a.AdmitResult(a.NO_BUDGET)
        if len(self.jobs) >= self.slots:
            return a.AdmitResult(a.POOL_FULL)
        self.jobs[req.rid] = self.waves
        return a.AdmitResult(a.OK, 0)

    def step_wave(self):
        progressed = sorted(self.jobs)
        done = []
        for rid in progressed:
            self.jobs[rid] -= 1
            if self.jobs[rid] <= 0:
                done.append((rid, [0] * self.waves))
                del self.jobs[rid]
        return done, progressed, len(progressed)

    def preempt(self, rid):
        return ("snap", rid, self.jobs.pop(rid))

    def restore(self, snap):
        if len(self.jobs) >= self.slots:
            return self.P.adm.AdmitResult(self.P.adm.POOL_FULL)
        self.jobs[snap[1]] = snap[2]
        return self.P.adm.AdmitResult(self.P.adm.OK, 0)

    def reset(self):
        self.jobs.clear()


def _req(P, rid, arrival, tier=0, length=5, max_new=4, patience=30.0,
         deadline=60.0):
    return P.W.Request(rid=rid, arrival=arrival, length=length, tier=tier,
                       max_new=max_new, patience=patience,
                       deadline=deadline)


# ---------------------------------------------------------------------------
# the two packages draw the same traffic
# ---------------------------------------------------------------------------

WORKLOADS = [
    dict(qps=3.0, horizon=20.0, seed=11, diurnal_amp=0.4,
         diurnal_period=10.0),
    dict(qps=5.0, horizon=60.0, seed=3, diurnal_amp=0.8,
         diurnal_period=10.0, tier_probs=(0.5, 0.3, 0.2)),
    dict(qps=30.0, horizon=2.0, seed=0, len_median=150.0, len_max=256),
    dict(qps=0.5, horizon=100.0, seed=7, len_sigma=1.2, len_min=2),
]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_traces_and_payloads_equal_between_packages(kw):
    J, T = _serving("repro"), _serving("repro_torch")
    jt, tt = (J.S.generate_trace(J.S.Workload(**kw)),
              T.S.generate_trace(T.S.Workload(**kw)))
    assert [dataclasses.astuple(r) for r in jt] == \
        [dataclasses.astuple(r) for r in tt]
    assert len(tt) > 0
    for rj, rt in list(zip(jt, tt))[:12]:
        for mode, extra in (("lm", dict(vocab=49152)),
                            ("asr", dict(input_dim=260))):
            a = J.S.make_payload(rj, mode=mode, seed=kw["seed"], **extra)
            b = T.S.make_payload(rt, mode=mode, seed=kw["seed"], **extra)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    t = np.linspace(0.0, 30.0, 61)
    assert [J.S.rate_at(J.S.Workload(**kw), x) for x in t] == \
        [T.S.rate_at(T.S.Workload(**kw), x) for x in t]


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def test_trace_deterministic_and_seeded(P):
    w = P.S.Workload(qps=3.0, horizon=20.0, seed=11, diurnal_amp=0.4,
                     diurnal_period=10.0)
    a, b = P.S.generate_trace(w), P.S.generate_trace(w)
    assert a == b and len(a) > 0
    assert all(a[i].arrival <= a[i + 1].arrival for i in range(len(a) - 1))
    assert [r.rid for r in a] == list(range(len(a)))
    assert P.S.generate_trace(dataclasses.replace(w, seed=1)) != a


@pytest.mark.parametrize("amp", [0.0, 0.8])
def test_empirical_rate_matches_lambda(P, amp):
    w = P.S.Workload(qps=5.0, horizon=200.0, seed=3, diurnal_amp=amp,
                     diurnal_period=10.0)
    n, mean = len(P.S.generate_trace(w)), w.qps * w.horizon
    assert abs(n - mean) < 4 * math.sqrt(mean)


def test_lengths_tiers_and_validation(P):
    w = P.S.Workload(qps=4.0, horizon=30.0, seed=5, len_min=2, len_max=9,
                     tier_probs=(0.5, 0.3, 0.2))
    trace = P.S.generate_trace(w)
    assert all(2 <= r.length <= 9 for r in trace)
    assert {r.tier for r in trace} <= {0, 1, 2}
    assert len({r.tier for r in trace}) > 1
    W = P.S.Workload
    with pytest.raises(ValueError, match="diurnal_amp"):
        P.S.generate_trace(W(qps=1.0, horizon=1.0, diurnal_amp=1.0))
    with pytest.raises(ValueError, match="positive"):
        P.S.generate_trace(W(qps=0.0, horizon=1.0))
    with pytest.raises(ValueError, match="tier_probs"):
        P.S.generate_trace(W(qps=1.0, horizon=1.0, tier_probs=(-0.5, 1.5)))


def test_payload_determinism_and_modes(P):
    req = _req(P, 7, 0.0, length=12)
    a = P.S.make_payload(req, mode="lm", vocab=64, seed=9)
    np.testing.assert_array_equal(a, P.S.make_payload(req, mode="lm",
                                                      vocab=64, seed=9))
    assert a.shape == (12,) and a.dtype == np.int32
    f = P.S.make_payload(req, mode="asr", input_dim=8, seed=9)
    assert f.shape == (12, 8) and f.dtype == np.float32
    with pytest.raises(ValueError):
        P.S.make_payload(req, mode="lm", vocab=0)
    with pytest.raises(ValueError):
        P.S.make_payload(req, mode="nope", vocab=4)


def test_rate_at_peak_and_trough_exact(P):
    w = P.S.Workload(qps=4.0, horizon=1.0, diurnal_amp=0.5,
                     diurnal_period=8.0)
    assert P.S.rate_at(w, 2.0) == pytest.approx(6.0)
    assert P.S.rate_at(w, 6.0) == pytest.approx(2.0)
    assert P.S.rate_at(P.S.Workload(qps=3.0, horizon=1.0), 12.3) == 3.0


def test_rate_at_monotone_in_amplitude(P):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(qps=st.floats(0.1, 50.0), amp1=st.floats(0.0, 0.98),
           amp2=st.floats(0.0, 0.98), frac=st.floats(0.01, 0.99))
    @settings(max_examples=50, deadline=None)
    def check(qps, amp1, amp2, frac):
        lo, hi = sorted((amp1, amp2))
        t = frac * 10.0
        w_lo = P.S.Workload(qps=qps, horizon=1.0, diurnal_amp=lo,
                            diurnal_period=10.0)
        w_hi = P.S.Workload(qps=qps, horizon=1.0, diurnal_amp=hi,
                            diurnal_period=10.0)
        s = math.sin(2.0 * math.pi * t / 10.0)
        if s > 0:
            assert P.S.rate_at(w_hi, t) >= P.S.rate_at(w_lo, t)
        elif s < 0:
            assert P.S.rate_at(w_hi, t) <= P.S.rate_at(w_lo, t)
        assert P.S.rate_at(w_hi, t) >= 0.0

    check()


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

def test_nearest_rank_percentiles(P):
    pct = P.S.percentile
    vals = list(range(1, 101))
    assert (pct(vals, 50), pct(vals, 95), pct(vals, 99),
            pct(vals, 100)) == (50, 95, 99, 100)
    assert pct([7.0], 99) == 7.0
    assert pct([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert math.isnan(pct([], 50))
    assert pct([1.0, float("nan"), 3.0], 100) == 3.0


def test_summarize_hand_built_trace(P):
    r = P.S.Recorder()
    for i, ft in enumerate([1.0, 2.0, 3.0, 4.0]):
        r.offered(i, tier=i % 2, arrival=10.0 * i, deadline=10.0 * i + 5)
        r.admitted(i, 10.0 * i + ft)
        r.first_token(i, 10.0 * i + ft)
        r.first_token(i, 10.0 * i + ft + 1.0)      # later stamps ignored
        r.done(i, 10.0 * i + ft + 2.0, n_tokens=3)
    r.offered(4, tier=0, arrival=100.0)
    r.abandoned(4, 101.0)
    r.offered(5, tier=1, arrival=200.0)
    r.rejected(5, 200.0, P.adm.PROMPT_TOO_LONG)
    s = P.S.summarize(r, n_tiers=2)
    assert (s["offered"], s["done"], s["abandoned"], s["rejected"],
            s["tokens"]) == (6, 4, 1, 1, 12)
    assert s["first_token"]["p50"] == 2.0 and s["first_token"]["p95"] == 4.0
    assert s["final"]["p50"] == 4.0
    assert s["deadline_miss_frac"] == pytest.approx(0.25)
    assert s["per_tier"][0]["done"] == 2 and s["per_tier"][1]["offered"] == 3
    rows = P.S.summary_rows(s, "load", "virtual s")
    assert any(n == "load/done/tier0" for n, _, _ in rows)
    for name, value, derived in rows:
        parts = P.S.csv_row(name, value, derived).split(",", 2)
        assert parts[0] == name
        float(parts[1])


# ---------------------------------------------------------------------------
# admission controller
# ---------------------------------------------------------------------------

def test_typed_terminal_rejections_recorded(P):
    ctl = P.adm.AdmissionController(FakeServer(P, 2, too_long=10),
                                    n_tiers=1)
    ctl.offer(_req(P, 0, 0.0, length=99), None)
    ctl.offer(_req(P, 1, 0.0, max_new=0), None)
    ctl.offer(_req(P, 2, 0.0), None)
    ctl.pump(0.0)
    evs = ctl.recorder.events
    assert (evs[0].outcome, evs[0].reject_reason) == \
        ("rejected", P.adm.PROMPT_TOO_LONG)
    assert (evs[1].outcome, evs[1].reject_reason) == \
        ("rejected", P.adm.NO_BUDGET)
    assert evs[2].outcome == "running"
    assert P.adm.RETRYABLE == (P.adm.POOL_FULL,)
    assert P.adm.TERMINAL == (P.adm.PROMPT_TOO_LONG, P.adm.NO_BUDGET)


def test_tier_order_and_fifo(P):
    srv = FakeServer(P, 2)
    ctl = P.adm.AdmissionController(srv, n_tiers=2)
    for rid, tier in [(0, 1), (1, 1), (2, 0)]:
        ctl.offer(_req(P, rid, 0.0, tier=tier), None)
    ctl.pump(0.0)
    assert set(srv.jobs) == {2, 0}


def test_preempts_lowest_priority_latest_admitted(P):
    srv = FakeServer(P, 3, waves=10)
    ctl = P.adm.AdmissionController(srv, n_tiers=3)
    for rid, tier in [(0, 2), (1, 1), (2, 2)]:
        ctl.offer(_req(P, rid, 0.0, tier=tier), None)
    ctl.pump(0.0)
    assert set(srv.jobs) == {0, 1, 2}
    ctl.offer(_req(P, 3, 1.0, tier=0), None)
    ctl.pump(1.0)
    # tier 2 holds rids 0 and 2: the later admission (2) is the victim
    assert set(srv.jobs) == {0, 1, 3}
    assert ctl.recorder.events[2].n_preempt == 1
    assert ctl.recorder.n_preemptions == 1
    assert ctl.queues[2][0].rid == 2           # at the front of its tier
    assert ctl.check_inversion() == []


def test_no_preemption_of_equal_priority_or_when_off(P):
    srv = FakeServer(P, 1, waves=10)
    ctl = P.adm.AdmissionController(srv, n_tiers=2)
    ctl.offer(_req(P, 0, 0.0, tier=0), None)
    ctl.pump(0.0)
    ctl.offer(_req(P, 1, 1.0, tier=0), None)
    ctl.pump(1.0)
    assert set(srv.jobs) == {0} and ctl.recorder.n_preemptions == 0
    srv = FakeServer(P, 1, waves=10)
    ctl = P.adm.AdmissionController(srv, n_tiers=2, preempt=False)
    ctl.offer(_req(P, 0, 0.0, tier=1), None)
    ctl.pump(0.0)
    ctl.offer(_req(P, 1, 1.0, tier=0), None)
    ctl.pump(1.0)
    assert set(srv.jobs) == {0} and ctl.check_inversion() == []


def test_abandonment_unstarted_only(P):
    srv = FakeServer(P, 1, waves=4)
    ctl = P.adm.AdmissionController(srv, n_tiers=2)
    ctl.offer(_req(P, 0, 0.0, tier=1, patience=0.1), None)
    ctl.pump(0.0)
    ctl.offer(_req(P, 1, 0.0, tier=0), None)
    ctl.offer(_req(P, 2, 0.0, tier=1, patience=0.1), None)
    ctl.pump(0.0)
    assert ctl.recorder.events[0].n_preempt == 1
    ctl.pump(5.0)
    evs = ctl.recorder.events
    assert evs[2].outcome == "abandoned"
    assert evs[0].outcome != "abandoned"
    assert ctl.queues[1][0].rid == 0


def test_invalid_tier_raises(P):
    ctl = P.adm.AdmissionController(FakeServer(P, 1), n_tiers=2)
    with pytest.raises(ValueError, match="tier"):
        ctl.offer(_req(P, 0, 0.0, tier=5), None)
    with pytest.raises(ValueError, match="n_tiers"):
        P.adm.AdmissionController(FakeServer(P, 1), n_tiers=0)


# ---------------------------------------------------------------------------
# the virtual-time loop
# ---------------------------------------------------------------------------

def _overload(P, collect=None, server=None):
    w = P.S.Workload(qps=6.0, horizon=5.0, seed=2, tier_probs=(0.3, 0.7),
                     patience=1.0, deadline=2.0)
    loop = P.S.ServingLoop(
        server or FakeServer(P, 2, waves=3), P.S.generate_trace(w),
        lambda req: None, n_tiers=2, clock=P.S.VirtualClock(),
        cost=P.S.CostModel(admit_s=0.05, wave_base_s=0.03, per_work_s=0.01),
        check_inversion=True, on_event=collect)
    loop.run()
    return loop


def test_loop_deterministic_without_inversion(P):
    ev1, ev2 = [], []
    l1 = _overload(P, lambda *a: ev1.append(a))
    l2 = _overload(P, lambda *a: ev2.append(a))
    assert ev1 == ev2 and len(ev1) > 0
    s = l1.summary()
    assert s == l2.summary()
    assert l1.inversions == [] and s["done"] > 0 and s["preemptions"] > 0
    for ev in l1.controller.recorder.events.values():
        assert ev.outcome in ("done", "abandoned", "rejected")
    assert s["offered"] == s["done"] + s["abandoned"] + s["rejected"]


def test_loops_of_both_packages_agree():
    """The same overload through both packages' controller and loop (on
    each package's fake server): the same events and summaries."""
    out = []
    for pkg in PKGS:
        P = _serving(pkg)
        ev = []
        loop = _overload(P, lambda *a: ev.append(a))
        out.append((ev, loop.summary(), loop.n_waves, loop.clock.now()))
    assert out[0] == out[1]


def test_first_token_includes_admit_cost(P):
    cost = P.S.CostModel(admit_s=0.5, wave_base_s=0.125, per_work_s=0.0)
    server = FakeServer(P, 1, waves=2)
    server.emits_on_admit = True
    loop = P.S.ServingLoop(server, [_req(P, 0, 0.0)], lambda r: None,
                           n_tiers=1, clock=P.S.VirtualClock(), cost=cost)
    loop.run()
    ev = loop.controller.recorder.events[0]
    assert ev.first_token == pytest.approx(0.5)
    assert ev.final == pytest.approx(0.5 + 2 * 0.125)
    loop = P.S.ServingLoop(FakeServer(P, 1, waves=2), [_req(P, 0, 0.0)],
                           lambda r: None, n_tiers=1,
                           clock=P.S.VirtualClock(), cost=cost)
    loop.run()
    assert loop.controller.recorder.events[0].first_token == \
        pytest.approx(0.5 + 0.125)


def test_idle_gap_jumps_to_next_arrival(P):
    loop = P.S.ServingLoop(FakeServer(P, 1, waves=1),
                           [_req(P, 0, 0.0), _req(P, 1, 100.0)],
                           lambda r: None, n_tiers=1,
                           clock=P.S.VirtualClock())
    loop.run()
    s = loop.summary()
    assert s["done"] == 2 and loop.clock.now() >= 100.0
    assert s["queue_wait"]["p99"] < 1.0


def test_wall_clock_sleeps_idle_gaps(P):
    clock = P.S.WallClock()
    clock.advance(5.0)                         # the compute is the delay
    assert clock.now() < 1.0
    clock.sleep_until(0.02)
    assert clock.now() >= 0.02


# ---------------------------------------------------------------------------
# capacity search
# ---------------------------------------------------------------------------

def _cap_workload(P):
    return P.S.Workload(qps=1.0, horizon=20.0, seed=4, patience=2.0,
                        deadline=2.0)


def test_bisection_midpoints_and_reproducible(P):
    cost = P.S.CostModel(admit_s=0.2, wave_base_s=0.1, per_work_s=0.0)
    srv = FakeServer(P, 2, waves=3)
    probes = []
    run_level = P.cap.run_level

    def spy(server, workload, payload_fn, **kw):
        probes.append(workload.qps)
        return run_level(server, workload, payload_fn, **kw)

    P.cap.run_level = spy
    try:
        q1, s1 = P.S.sustained_capacity(srv, _cap_workload(P),
                                        lambda r: None, p99_target_s=1.0,
                                        qps_lo=0.25, qps_hi=16.0, iters=4,
                                        cost=cost)
    finally:
        P.cap.run_level = run_level
    q2, s2 = P.S.sustained_capacity(srv, _cap_workload(P), lambda r: None,
                                    p99_target_s=1.0, qps_lo=0.25,
                                    qps_hi=16.0, iters=4, cost=cost)
    assert q1 == q2 and s1 == s2 and 0.25 <= q1 < 16.0
    assert P.cap.feasible(s1, p99_target_s=1.0)
    # the probes: both ends, then exact midpoints of the bracket
    assert probes[:3] == [0.25, 16.0, 8.125]
    lo, hi = 0.25, 16.0
    for q in probes[2:]:
        assert q == 0.5 * (lo + hi)
        if q <= q1:
            lo = q
        else:
            hi = q
    above = run_level(srv, _cap_workload(P).with_qps(16.0), lambda r: None,
                      cost=cost)
    assert not P.cap.feasible(above, p99_target_s=1.0)


def test_infeasible_floor_and_feasible_ceiling(P):
    w = _cap_workload(P)
    slow = P.S.CostModel(admit_s=5.0, wave_base_s=5.0)
    q, s = P.S.sustained_capacity(FakeServer(P, 1, waves=3), w,
                                  lambda r: None, p99_target_s=0.5,
                                  qps_lo=0.25, qps_hi=4.0, iters=2,
                                  cost=slow)
    assert q == 0.0 and not P.cap.feasible(s, p99_target_s=0.5)
    fast = P.S.CostModel(admit_s=1e-4, wave_base_s=1e-4)
    q, s = P.S.sustained_capacity(FakeServer(P, 4, waves=1), w,
                                  lambda r: None, p99_target_s=0.5,
                                  qps_lo=0.25, qps_hi=4.0, iters=2,
                                  cost=fast)
    assert q == 4.0 and P.cap.feasible(s, p99_target_s=0.5)


def test_capacity_equal_between_packages():
    out = []
    for pkg in PKGS:
        P = _serving(pkg)
        cost = P.S.CostModel(admit_s=0.2, wave_base_s=0.1, per_work_s=0.01)
        out.append(P.S.sustained_capacity(
            FakeServer(P, 2, waves=3), _cap_workload(P), lambda r: None,
            p99_target_s=1.0, qps_lo=0.25, qps_hi=16.0, iters=5, cost=cost))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the port's servers through the loop (CPU, reduced width)
# ---------------------------------------------------------------------------

def _port_server(kind):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import AsrServer, PagedServer, Server

    if kind == "asr":
        cfg = dataclasses.replace(
            get_arch("swb2000-blstm").reduced(), n_layers=1, lstm_hidden=32,
            lstm_bottleneck=16, input_dim=16, vocab=32, beam_width=3)
        return cfg, AsrServer(cfg, slots=2, max_frames=16, chunk=4,
                              device="cpu"), "asr"
    cfg = get_arch("smollm-360m").reduced()
    if kind == "paged":
        return cfg, PagedServer(cfg, pool_pages=8, page_size=4, max_len=16,
                                device="cpu"), "lm"
    return cfg, Server(cfg, slots=2, max_len=16, device="cpu"), "lm"


@pytest.mark.parametrize("kind", ["dense", "paged", "asr"])
def test_port_server_loop_seeded_reproducible(kind):
    from repro_torch import serving as S

    cfg, server, mode = _port_server(kind)
    w = S.Workload(qps=60.0, horizon=0.25, seed=7, len_median=6.0,
                   len_min=2, len_max=S.prompt_capacity(16, mode), max_new=4,
                   patience=0.6, deadline=2.0)
    payload = lambda req: S.make_payload(req, mode=mode, vocab=cfg.vocab,
                                         input_dim=cfg.input_dim,
                                         seed=w.seed)

    def run():
        server.reset()
        events = []
        loop = S.ServingLoop(server, S.generate_trace(w), payload,
                             n_tiers=2, clock=S.VirtualClock(),
                             cost=S.CostModel(), check_inversion=True,
                             on_event=lambda *a: events.append(a))
        loop.run()
        return events, loop.summary(), loop.inversions

    (e1, s1, inv1), (e2, s2, inv2) = run(), run()
    assert e1 == e2 and s1 == s2
    assert inv1 == [] and inv2 == []
    assert s1["done"] > 0 and s1["preemptions"] > 0
    assert s1["offered"] == s1["done"] + s1["abandoned"] + s1["rejected"]


def test_port_server_capacity_reuses_one_server():
    from repro_torch import serving as S

    cfg, server, _ = _port_server("dense")
    w = S.Workload(qps=1.0, horizon=1.0, seed=1, len_median=5.0, len_min=2,
                   len_max=15, max_new=3, patience=1.0, deadline=2.0)
    payload = lambda req: S.make_payload(req, mode="lm", vocab=cfg.vocab,
                                         seed=w.seed)
    cost = S.CostModel(admit_s=0.02, wave_base_s=0.01)
    q, s = S.sustained_capacity(server, w, payload, p99_target_s=0.1,
                                qps_lo=0.5, qps_hi=64.0, iters=2, cost=cost)
    assert 0.5 <= q <= 64.0 and s["qps"] == q
    assert S.capacity.feasible(s, p99_target_s=0.1)
