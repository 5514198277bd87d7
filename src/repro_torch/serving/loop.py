"""The serving event loop: arrivals -> admission -> decode waves ->
SLO accounting, in *virtual time* by default (docs/serving.md
§Virtual time).

**Virtual-time contract.**  A :class:`VirtualClock` only moves when the
loop tells it to: each admission costs ``CostModel.admit_s`` (the
prefill / BLSTM-forward service time) and each decode wave costs
``CostModel.wave_s(work)`` (a base wave cost plus a per-token/per-frame
term).  No wall-clock sleeps ever happen, so a whole overload scenario
runs in milliseconds of real time, the timeline is a pure function of
``(trace, cost model, scheduler)``, and re-running the same seed
reproduces every timestamp exactly — which is what makes the capacity
report of ``benchmarks/run.py --only load`` reproducible row-for-row.
:class:`WallClock` swaps in for benches: ``now`` is real elapsed time,
``advance`` is a no-op (the real compute provides the delay) and idle
gaps actually sleep until the next arrival.

The loop drives any server implementing the slot-pool duck contract
(``submit`` / ``step_wave`` / ``preempt`` / ``restore`` / ``reset`` —
see ``repro_torch.serving.admission``), with the
:class:`~repro_torch.serving.admission.AdmissionController` deciding who
occupies slots.  One iteration: deliver due arrivals, pump admissions
(abandonment, priority, preemption), then advance every active slot one
wave and stamp first-token/completion events at the post-wave clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.slo import Recorder, summarize


class VirtualClock:
    """Deterministic loop-driven clock (virtual seconds from 0)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += dt

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, t)


class WallClock:
    """Real elapsed time; ``advance`` is a no-op (the measured compute
    itself provides the delay), idle gaps really sleep."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> None:
        pass

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


@dataclass(frozen=True)
class CostModel:
    """Virtual service times (seconds) of the slot-pool operations.

    These are *nominal* constants pinned per (mode × kernel-impl) cell
    in the capacity bench — deterministic by construction; real-hardware
    truth is a ROADMAP item, wall-clock runs use :class:`WallClock`
    where the cost model is ignored.
    """

    admit_s: float = 0.020       # prefill / BLSTM forward per admission
    wave_base_s: float = 0.010   # fixed cost of one decode wave
    per_work_s: float = 0.0      # per token decoded / frame consumed

    def wave_s(self, work: int) -> float:
        return self.wave_base_s + self.per_work_s * work


class ServingLoop:
    """Drive one server through one offered trace (module docstring)."""

    def __init__(self, server, trace, payload_fn: Callable, *,
                 n_tiers: int, clock=None, cost: CostModel = None,
                 preempt: bool = True, check_inversion: bool = False,
                 max_waves: int = 200_000,
                 on_event: Optional[Callable] = None):
        self.server = server
        self.trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        self.payload_fn = payload_fn
        self.clock = clock if clock is not None else VirtualClock()
        self.cost = cost if cost is not None else CostModel()
        self.controller = AdmissionController(server, n_tiers=n_tiers,
                                              preempt=preempt)
        self.check_inversion = check_inversion
        self.max_waves = max_waves
        self.on_event = on_event
        self.n_waves = 0
        self.inversions = []

    # ---------------------------------------------------------------- run
    def run(self) -> Recorder:
        i, ctl, clock = 0, self.controller, self.clock
        while True:
            now = clock.now()
            while i < len(self.trace) and self.trace[i].arrival <= now:
                req = self.trace[i]
                ctl.offer(req, self.payload_fn(req))
                self._emit("offer", req.rid, tier=req.tier)
                i += 1
            ctl.pump(now, advance=self._admit_tick)
            if self.check_inversion:
                self.inversions += ctl.check_inversion()
            if ctl.running:
                completed, progressed, work = self.server.step_wave()
                clock.advance(self.cost.wave_s(work))
                ctl.on_wave(completed, progressed, clock.now())
                for rid, tokens in completed:
                    self._emit("done", rid, n_tokens=len(tokens))
                self.n_waves += 1
                if self.n_waves > self.max_waves:
                    raise RuntimeError(
                        f"serving loop exceeded {self.max_waves} waves")
            elif i < len(self.trace):
                clock.sleep_until(self.trace[i].arrival)
            elif ctl.backlog():
                # idle pool + non-empty queue: only queued waiters whose
                # patience has not expired can be left (the pump admits
                # otherwise); jump to the next abandonment horizon
                clock.sleep_until(min(
                    j.req.arrival + j.req.patience
                    for q in ctl.queues for j in q) + 1e-9)
            else:
                break
        return ctl.recorder

    def summary(self) -> dict:
        return summarize(self.controller.recorder,
                         n_tiers=len(self.controller.queues))

    def _admit_tick(self) -> float:
        """Charge one admission's service time; the controller stamps
        the admitted request at the returned (post-prefill) clock."""
        self.clock.advance(self.cost.admit_s)
        return self.clock.now()

    def _emit(self, kind, rid, **kw) -> None:
        if self.on_event is not None:
            self.on_event(kind, rid, self.clock.now(), kw)
