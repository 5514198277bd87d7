"""Per-request latency accounting and the shared stats CSV schema.

Every serving-side surface reports through the same two primitives:

* :class:`RequestEvents` — one record per offered request, holding the
  raw event timestamps (arrival, first admit, first token, final
  result) plus the preemption count and the terminal outcome.  The
  :class:`Recorder` owns the table; the admission controller and the
  serving loop stamp it as events happen.  Timestamps are whatever the
  loop's clock says — *virtual* seconds in tests/benches, wall seconds
  in ``--wall`` mode — so the same accounting code covers both.
* ``name,value,derived`` CSV rows — the schema ``benchmarks/run.py``
  and ``launch/evaluate.py`` already print; the formatting source now
  lives in :mod:`repro_torch.obs` (:func:`repro_torch.obs.csv_row` /
  :func:`repro_torch.obs.print_csv_rows`); this module re-exports them as
  deprecation shims (docs/serving.md §Report schema).

The :class:`Recorder` is a *view* over the shared observability event
schema (docs/observability.md): every stamping method emits a
``request/*`` event through ``repro_torch.obs`` (a no-op unless a launcher
enabled tracing) and applies it to the live table via the same
:func:`_apply` fold that :func:`fold_request_events` uses to rebuild a
table from a recorded JSONL — so the flight recorder and the in-memory
table can never disagree (property-tested in tests/test_obs.py).

SLO definitions (docs/serving.md §SLOs):

* **queue wait**   = first admit − arrival (admitted requests only),
* **first token**  = first emitted token/progress − arrival,
* **final result** = completion − arrival,
* percentiles use the **nearest-rank** convention: ``p_q`` of ``n``
  sorted samples is element ``ceil(q/100 · n) − 1`` — deterministic,
  no interpolation, so hand-built traces have exactly computable
  p50/p95/p99 (property-tested in tests/test_serving.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch import obs
from repro_torch.obs import CSV_HEADER, csv_row, print_csv_rows  # noqa: F401
# ^ moved to repro_torch.obs (single formatting source); re-exported here as
#   deprecation shims for existing importers.

NAN = float("nan")


@dataclass
class RequestEvents:
    """Raw per-request event timestamps (clock units of the loop)."""

    rid: int
    tier: int
    arrival: float
    deadline: float = math.inf   # final-result SLO bound (accounting only)
    t_admit: float = NAN         # first admission
    t_first: float = NAN         # first token / first decode progress
    t_done: float = NAN          # final result
    n_preempt: int = 0
    n_tokens: int = 0
    outcome: str = "offered"     # offered|running|done|abandoned|rejected
    reject_reason: str = ""

    # latencies (NaN while the event has not happened)
    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.arrival

    @property
    def first_token(self) -> float:
        return self.t_first - self.arrival

    @property
    def final(self) -> float:
        return self.t_done - self.arrival


def _apply(rec: "Recorder", name: str, attrs: dict) -> None:
    """Fold one ``request/*`` schema event into a recorder's table.
    The single transition function shared by the live :class:`Recorder`
    (stamping methods route through it) and the offline
    :func:`fold_request_events` rebuild — unknown rids raise KeyError,
    matching the historical stamping semantics."""
    a = attrs
    table = rec.events
    if name == "request/offered":
        table[a["rid"]] = RequestEvents(
            a["rid"], a["tier"], a["arrival"],
            deadline=a.get("deadline", math.inf))
    elif name == "request/admitted":
        ev = table[a["rid"]]
        if math.isnan(ev.t_admit):          # first admission only
            ev.t_admit = a["now"]
        ev.outcome = "running"
    elif name == "request/first_token":
        ev = table[a["rid"]]
        if math.isnan(ev.t_first):
            ev.t_first = a["now"]
    elif name == "request/preempted":
        table[a["rid"]].n_preempt += 1
        rec.n_preemptions += 1
    elif name == "request/done":
        ev = table[a["rid"]]
        ev.t_done = a["now"]
        ev.n_tokens = a.get("n_tokens", 0)
        ev.outcome = "done"
    elif name == "request/abandoned":
        ev = table[a["rid"]]
        ev.t_done = a["now"]
        ev.outcome = "abandoned"
    elif name == "request/rejected":
        ev = table[a["rid"]]
        ev.t_done = a["now"]
        ev.outcome = "rejected"
        ev.reject_reason = a["reason"]
    else:
        raise ValueError(f"unknown request event {name!r}")


class Recorder:
    """The per-request event table: a live view over the shared
    ``request/*`` event schema.  Each stamping method tees the event to
    ``repro_torch.obs`` (free while tracing is off) and folds it into the
    table via :func:`_apply`; summarized by :func:`summarize`."""

    def __init__(self, emit: bool = True):
        self.events: dict[int, RequestEvents] = {}
        self.n_preemptions = 0
        self._emit = emit

    def _stamp(self, name, **attrs):
        if self._emit:
            obs.event(name, **attrs)
        _apply(self, name, attrs)

    def offered(self, rid, tier, arrival, deadline=math.inf):
        self._stamp("request/offered", rid=rid, tier=tier,
                    arrival=arrival, deadline=deadline)

    def admitted(self, rid, now):
        self._stamp("request/admitted", rid=rid, now=now)

    def first_token(self, rid, now):
        self._stamp("request/first_token", rid=rid, now=now)

    def preempted(self, rid):
        self._stamp("request/preempted", rid=rid)

    def done(self, rid, now, n_tokens=0):
        self._stamp("request/done", rid=rid, now=now, n_tokens=n_tokens)

    def abandoned(self, rid, now):
        self._stamp("request/abandoned", rid=rid, now=now)

    def rejected(self, rid, now, reason):
        self._stamp("request/rejected", rid=rid, now=now, reason=reason)


def fold_request_events(events) -> Recorder:
    """Rebuild a request table from recorded schema events (the
    ``request/*`` instants of a JSONL trace).  By construction
    ``fold(trace).events == live.events`` for the run that emitted the
    trace — the view-consistency property tests/test_obs.py asserts."""
    rec = Recorder(emit=False)
    for ev in events:
        name = ev.get("name", "")
        if ev.get("kind") == "event" and name.startswith("request/"):
            _apply(rec, name, ev.get("attrs", {}))
    return rec


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: element ``ceil(q/100 * n) - 1`` of the
    sorted sample (q in (0, 100]); NaN on an empty sample."""
    vals = sorted(v for v in values if not math.isnan(v))
    if not vals:
        return NAN
    rank = max(int(math.ceil(q / 100.0 * len(vals))), 1)
    return vals[min(rank, len(vals)) - 1]


_QS = (50, 95, 99)


def _pcts(values):
    return {f"p{q}": percentile(values, q) for q in _QS}


def summarize(recorder: Recorder, n_tiers: int = None) -> dict:
    """Aggregate the event table into the SLO summary dict: outcome
    counts (overall and per tier), nearest-rank p50/p95/p99 of queue
    wait / first-token / final-result latency, and the deadline-miss
    fraction of completed requests."""
    evs = list(recorder.events.values())
    if n_tiers is None:
        n_tiers = max((e.tier for e in evs), default=-1) + 1
    done = [e for e in evs if e.outcome == "done"]
    admitted = [e for e in evs if not math.isnan(e.t_admit)]
    out = {
        "offered": len(evs),
        "done": len(done),
        "abandoned": sum(e.outcome == "abandoned" for e in evs),
        "rejected": sum(e.outcome == "rejected" for e in evs),
        "preemptions": recorder.n_preemptions,
        "tokens": sum(e.n_tokens for e in done),
        "queue_wait": _pcts([e.queue_wait for e in admitted]),
        "first_token": _pcts([e.first_token for e in evs]),
        "final": _pcts([e.final for e in done]),
        "deadline_miss_frac": (
            sum(e.t_done > e.deadline for e in done) / len(done)
            if done else 0.0),
        "per_tier": {},
    }
    for t in range(n_tiers):
        te = [e for e in evs if e.tier == t]
        td = [e for e in te if e.outcome == "done"]
        out["per_tier"][t] = {
            "offered": len(te),
            "done": len(td),
            "abandoned": sum(e.outcome == "abandoned" for e in te),
            "first_token_p99": percentile([e.first_token for e in te], 99),
            "final_p99": percentile([e.final for e in td], 99),
        }
    return out


def summary_rows(summary: dict, prefix: str, derived: str = ""):
    """Flatten a :func:`summarize` dict into ``(name, value, derived)``
    rows of the shared CSV schema (the capacity-report cell layout —
    docs/serving.md §Report schema)."""
    rows = [(f"{prefix}/{k}", float(summary[k]), derived)
            for k in ("offered", "done", "abandoned", "rejected",
                      "preemptions", "tokens", "deadline_miss_frac")]
    for metric in ("queue_wait", "first_token", "final"):
        for q, v in summary[metric].items():
            rows.append((f"{prefix}/{metric}_{q}", v,
                         f"{derived} ({metric} {q}, s)".strip()))
    for t, tv in summary["per_tier"].items():
        rows.append((f"{prefix}/done/tier{t}", float(tv["done"]),
                     f"of {tv['offered']} offered in tier {t}"))
        rows.append((f"{prefix}/first_token_p99/tier{t}",
                     tv["first_token_p99"], f"tier {t} first-token p99, s"))
    return rows


# NOTE: CSV_HEADER / csv_row / print_csv_rows moved to repro_torch.obs (the
# single formatting source); imported above and re-exported for
# backward compatibility.
