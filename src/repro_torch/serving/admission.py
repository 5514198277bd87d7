"""Continuous-batching admission control: typed admission results,
priority tiers, and slot preemption (docs/serving.md §Admission).

The controller is server-agnostic — it drives any object implementing
the slot-pool duck contract of ``repro_torch.launch.serve``:

* ``submit(req, payload) -> AdmitResult`` — claim a free slot (typed
  rejection otherwise),
* ``preempt(rid) -> snapshot`` — evict a running request, returning an
  opaque snapshot that fully captures its decode state (LM: the cache
  row + position/budget; ASR: the ``BeamState`` row + posteriors),
* ``restore(snapshot) -> AdmitResult`` — resume a preempted request in
  any free slot, bit-for-bit (preempt-then-resume equals the
  uninterrupted decode — tested),
* ``emits_on_admit`` — True when admission itself produces the first
  token (LM prefill does; ASR streams its first progress on the first
  wave after admission).

**Tiers.**  Tier 0 is the highest priority.  Queued requests admit
high-tier-first, FIFO within a tier; a queued request may *preempt* a
running one of strictly lower priority when the pool is full (victim =
the lowest-priority running request, most recently admitted among
equals).  Preempted jobs re-enter at the *front* of their tier's queue
holding their snapshot, so they resume before anything newer of the
same tier.  The no-priority-inversion invariant (with preemption on):
after a ``pump``, no queued job has strictly higher priority than any
running job (``check_inversion`` — asserted over whole virtual-time
runs in tests/test_serving.py).

**Abandonment.**  A request that has never been admitted abandons the
queue once it has waited past its ``patience`` (the workload model's
user walking away).  Preempted requests already started and never
abandon.

Everything here is deterministic given the offered trace: queues are
plain FIFOs, the victim choice is a total order, and all timestamps
come from the loop's clock.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.serving.slo import Recorder
from repro_torch.serving.workload import Request

# typed admission outcomes (docs/serving.md §Admission)
OK = "ok"                          # admitted into a slot
POOL_FULL = "pool_full"            # every slot busy (retryable)
PROMPT_TOO_LONG = "prompt_too_long"  # payload exceeds the slot capacity
NO_BUDGET = "no_budget"            # nothing to decode (max_new/frames <= 0)

RETRYABLE = (POOL_FULL,)
TERMINAL = (PROMPT_TOO_LONG, NO_BUDGET)


@dataclass(frozen=True)
class AdmitResult:
    """Typed admission outcome; truthy iff admitted (so existing
    ``while pending and server.admit(...)`` loops keep working)."""

    reason: str
    slot: int = -1

    def __bool__(self) -> bool:
        return self.reason == OK


ADMITTED = AdmitResult(OK)


def prompt_capacity(max_len: int, mode: str) -> int:
    """The documented LM/ASR payload-capacity contract, hoisted from the
    two former call-site magic numbers (serve.py's clamp and the
    servers' admit validation must agree or a clamped payload is
    terminally rejected):

    * ``lm``  — a slot holds ``max_len`` cache positions but ONE is
      reserved for the first generated token the prefill emits, so the
      prompt may fill at most ``max_len - 1``.
    * ``asr`` — the whole posterior buffer is decodable: an utterance
      may fill all ``max_len`` frames (nothing is generated into the
      buffer).
    """
    if mode == "lm":
        return max_len - 1
    if mode == "asr":
        return max_len
    raise ValueError(f"unknown payload mode {mode!r}")


@dataclass(eq=False)
class Job:
    """One request's life in the controller: queued -> running
    (-> preempted -> queued -> running)* -> done, or abandoned/rejected
    before ever running."""

    req: Request
    payload: object
    state: str = "queued"    # queued|running|preempted|done|...
    snapshot: object = None  # set while preempted

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def tier(self) -> int:
        return self.req.tier


class AdmissionController:
    """Priority-tiered admission with optional preemption over one
    slot-pool server (module docstring for semantics)."""

    def __init__(self, server, *, n_tiers: int, preempt: bool = True,
                 recorder: Optional[Recorder] = None):
        if n_tiers < 1:
            raise ValueError(f"n_tiers must be >= 1, got {n_tiers}")
        self.server = server
        self.queues = [deque() for _ in range(n_tiers)]
        self.running: dict[int, Job] = {}
        self.preempt_enabled = preempt
        self.recorder = recorder if recorder is not None else Recorder()

    # ------------------------------------------------------------- intake
    def offer(self, req: Request, payload) -> None:
        if not 0 <= req.tier < len(self.queues):
            raise ValueError(
                f"request {req.rid} tier {req.tier} outside the "
                f"{len(self.queues)}-tier controller")
        self.queues[req.tier].append(Job(req, payload))
        self.recorder.offered(req.rid, req.tier, req.arrival,
                              deadline=req.arrival + req.deadline)

    def backlog(self) -> int:
        return sum(len(q) for q in self.queues)

    # ------------------------------------------------------------ pumping
    def pump(self, now: float, advance=None) -> int:
        """Drop abandoned waiters, then admit as much of the queue as the
        pool (plus preemption) allows.  Returns the number of slots
        filled this pump (admissions + restores).  ``advance``, when
        given, is called once per successful admission and returns the
        post-admission clock — so the admit service time (prefill /
        BLSTM forward) is charged *before* the request's admission and
        first-token stamps."""
        self._abandon(now)
        n_admitted = 0
        for tier, q in enumerate(self.queues):
            while q:
                job = q[0]
                res = self._try_admit(job)
                if res:
                    q.popleft()
                    if advance is not None:
                        now = advance()
                    self._mark_running(job, now)
                    n_admitted += 1
                elif res.reason == POOL_FULL:
                    victim = self._pick_victim(tier)
                    if victim is None:
                        # nothing of lower priority runs, so neither this
                        # tier nor any lower one can make progress
                        return n_admitted
                    self._do_preempt(victim)
                else:                      # terminal typed rejection
                    q.popleft()
                    job.state = "rejected"
                    self.recorder.rejected(job.rid, now, res.reason)
        return n_admitted

    def _try_admit(self, job: Job) -> AdmitResult:
        if job.snapshot is not None:
            res = self.server.restore(job.snapshot)
            if res:
                job.snapshot = None
            return res
        return self.server.submit(job.req, job.payload)

    def _mark_running(self, job: Job, now: float) -> None:
        first = job.state == "queued"
        job.state = "running"
        self.running[job.rid] = job
        self.recorder.admitted(job.rid, now)
        if first and getattr(self.server, "emits_on_admit", False):
            self.recorder.first_token(job.rid, now)

    def _abandon(self, now: float) -> None:
        for q in self.queues:
            kept, gone = [], []
            for j in q:
                started = j.snapshot is not None or j.state == "preempted"
                if started or now - j.req.arrival <= j.req.patience:
                    kept.append(j)
                else:
                    gone.append(j)
            if gone:
                for j in gone:
                    j.state = "abandoned"
                    self.recorder.abandoned(j.rid, now)
                q.clear()
                q.extend(kept)

    def _pick_victim(self, tier: int) -> Optional[Job]:
        """Lowest-priority running job strictly below ``tier``'s
        priority; the most recently admitted breaks ties (it has the
        least sunk work).  Deterministic: dict preserves insertion
        (= admission) order."""
        if not self.preempt_enabled:
            return None
        victim = None
        for job in self.running.values():        # admission order
            if job.tier <= tier:
                continue
            if victim is None or job.tier > victim.tier:
                victim = job
            elif job.tier == victim.tier:
                victim = job                     # later admission wins
        return victim

    def _do_preempt(self, victim: Job) -> None:
        victim.snapshot = self.server.preempt(victim.rid)
        victim.state = "preempted"
        del self.running[victim.rid]
        self.queues[victim.tier].appendleft(victim)
        self.recorder.preempted(victim.rid)

    # ---------------------------------------------------------- wave side
    def on_wave(self, completed, progressed, now: float) -> None:
        """Stamp one decode wave: ``progressed`` request ids advanced
        this wave (first progress = first token for streaming servers),
        ``completed`` is ``[(rid, tokens), ...]``."""
        for rid in progressed:
            self.recorder.first_token(rid, now)
        for rid, tokens in completed:
            job = self.running.pop(rid, None)
            if job is not None:
                job.state = "done"
            self.recorder.done(rid, now, n_tokens=len(tokens))

    # --------------------------------------------------------- invariants
    def check_inversion(self):
        """Priority-inversion witnesses: (queued_tier, running_tier)
        pairs with a queued job of strictly higher priority than a
        running one.  Empty after every pump when preemption is on."""
        if not self.preempt_enabled:
            return []
        queued = [t for t, q in enumerate(self.queues) if q]
        if not queued:
            return []
        lowest_queued = min(queued)
        return [(lowest_queued, job.tier) for job in self.running.values()
                if job.tier > lowest_queued]
