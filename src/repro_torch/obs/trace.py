"""Span tracing, the JSONL flight recorder, and the Chrome trace
exporter (docs/observability.md §Event schema).

The :class:`FlightRecorder` is a bounded ring buffer of event dicts —
one shared schema for spans (timed regions), instant events (the
structured per-request / per-step records every launcher used to print
ad-hoc) and metric snapshots:

    {"seq": int, "kind": "span" | "event" | "metric", "name": str,
     "ts": float s, "dur": float s (spans), "id"/"parent": int (spans),
     "attrs": {str: scalar}, ...}

* ``seq`` is a per-recorder monotone id assigned at *entry* — it is a
  pure function of the call sequence, so seeded runs produce identical
  seqs (the run-twice bit-equality gate).
* ``ts``/``dur`` are wall-clock (``time.perf_counter``) and the ONLY
  nondeterministic fields; :func:`write_jsonl` with
  ``deterministic=True`` strips them (and drops whole events marked
  ``wall``) so two seeded runs emit byte-identical JSONL.
* Spans nest: ``with recorder.span("mix", learner=3):`` records its
  parent span's id, so the exporter and ``launch/obsreport.py`` can
  attribute child time correctly.
* Memory is bounded: ``maxlen`` caps the ring (oldest events drop;
  ``n_dropped`` counts them), so a long run cannot OOM the recorder.

:func:`chrome_trace` converts an event list to the Chrome
``trace_event`` JSON (``chrome://tracing`` / https://ui.perfetto.dev):
spans become complete ("X") events, instants "i", metric snapshots
counter ("C") series.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

KINDS = ("span", "event", "metric")

# JSON-scalar attr values only: the schema stays greppable and every
# line round-trips through json without custom encoders
_SCALARS = (str, int, float, bool, type(None))

DEFAULT_MAXLEN = 65536


class FlightRecorder:
    """Bounded in-memory ring of schema events (module docstring)."""

    def __init__(self, maxlen: int = DEFAULT_MAXLEN,
                 clock=time.perf_counter):
        self._events = deque(maxlen=maxlen)
        self._clock = clock
        self._seq = 0
        self._stack: list = []          # open-span ids (launchers are
        self.maxlen = maxlen            # single-threaded)

    # ------------------------------------------------------------- state
    @property
    def events(self) -> list:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def n_dropped(self) -> int:
        """Events evicted by the ring bound."""
        return self._seq - len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._seq = 0
        self._stack.clear()

    # ----------------------------------------------------------- records
    def event(self, name: str, **attrs) -> None:
        """One instant event (a step record, a request transition)."""
        self._seq += 1
        self._events.append({"seq": self._seq, "kind": "event",
                             "name": name, "ts": self._clock(),
                             "attrs": attrs})

    def metric(self, rec: dict) -> None:
        """One metric-snapshot record (see MetricsRegistry.snapshot);
        the instrument's own ``kind`` lands as ``instrument`` (the
        event ``kind`` stays ``metric``); ``wall`` metrics are dropped
        by the deterministic export."""
        self._seq += 1
        ev = {"seq": self._seq, "kind": "metric", "ts": self._clock()}
        for k, v in rec.items():
            ev["instrument" if k == "kind" else k] = v
        self._events.append(ev)

    def add_span(self, name: str, t0: float, dur: float,
                 wall: bool = False, **attrs) -> None:
        """Append an already-timed span (the ProfiledFn path: the
        caller measured ``dur`` itself, e.g. around a blocked jit
        call).  ``wall=True`` marks it wall-clock-derived, so the
        deterministic export drops the whole event."""
        self._seq += 1
        ev = {"seq": self._seq, "kind": "span", "name": name,
              "ts": t0, "dur": dur, "id": self._seq,
              "parent": self._stack[-1] if self._stack else 0,
              "attrs": attrs}
        if wall:
            ev["wall"] = True
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, **attrs):
        """Timed region: ``with recorder.span("mix", learner=i): ...``
        The record lands at exit (children therefore precede parents in
        the stream); ``id``/``parent`` reconstruct the nesting."""
        self._seq += 1
        sid = self._seq
        parent = self._stack[-1] if self._stack else 0
        self._stack.append(sid)
        t0 = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - t0
            self._stack.pop()
            self._events.append({"seq": sid, "kind": "span", "name": name,
                                 "ts": t0, "dur": dur, "id": sid,
                                 "parent": parent, "attrs": attrs})


class NullRecorder(FlightRecorder):
    """The disabled default: every record is a pass, ``span`` is a
    shared no-op context — instrumentation sites cost one call."""

    def __init__(self):
        super().__init__(maxlen=1)

    def event(self, name: str, **attrs) -> None:
        pass

    def metric(self, rec: dict) -> None:
        pass

    def add_span(self, name: str, t0: float, dur: float,
                 wall: bool = False, **attrs) -> None:
        pass

    @contextmanager
    def span(self, name: str, **attrs):
        yield


NULL_RECORDER = NullRecorder()


# ---------------------------------------------------------------------------
# JSONL export / import
# ---------------------------------------------------------------------------

# fields carrying wall-clock time, stripped by the deterministic export
_WALL_FIELDS = ("ts", "dur")


def event_to_line(ev: dict, deterministic: bool = False):
    """One JSONL line (sorted keys, so byte-stable), or None when the
    deterministic export drops the event entirely (wall-marked)."""
    if deterministic:
        if ev.get("wall"):
            return None
        ev = {k: v for k, v in ev.items() if k not in _WALL_FIELDS}
    return json.dumps(ev, sort_keys=True)


def write_jsonl(events, path: str, deterministic: bool = False) -> int:
    """Write the flight-recorder events as JSONL; returns lines
    written.  ``deterministic=True`` strips wall-clock fields and drops
    wall-marked events so seeded re-runs are byte-identical."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for ev in events:
            line = event_to_line(ev, deterministic)
            if line is not None:
                f.write(line + "\n")
                n += 1
    return n


def read_jsonl(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_events(events) -> list:
    """Schema problems as strings (empty = valid).  The contract every
    emitted JSONL must satisfy (the CI obs smoke gates on it)."""
    problems = []
    seen = set()
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        seq = ev.get("seq")
        if not isinstance(seq, int):
            problems.append(f"{where}: missing/non-int seq")
        elif seq in seen:
            problems.append(f"{where}: duplicate seq {seq}")
        else:
            seen.add(seq)
        if ev.get("kind") not in KINDS:
            problems.append(f"{where}: kind {ev.get('kind')!r} not in "
                            f"{KINDS}")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing name")
        for fld in _WALL_FIELDS:
            if fld in ev and not isinstance(ev[fld], (int, float)):
                problems.append(f"{where}: {fld} not numeric")
        if ev.get("kind") == "span":
            if "dur" in ev and ev["dur"] < 0:
                problems.append(f"{where}: negative span dur")
            for fld in ("id", "parent"):
                if fld in ev and not isinstance(ev[fld], int):
                    problems.append(f"{where}: span {fld} not int")
        attrs = ev.get("attrs", {})
        if not isinstance(attrs, dict):
            problems.append(f"{where}: attrs not an object")
        else:
            for k, v in attrs.items():
                if not isinstance(k, str):
                    problems.append(f"{where}: non-str attr key {k!r}")
                if not isinstance(v, _SCALARS):
                    problems.append(f"{where}: attr {k}={type(v).__name__}"
                                    f" not a JSON scalar")
    return problems


# ---------------------------------------------------------------------------
# Chrome trace_event exporter
# ---------------------------------------------------------------------------

def chrome_trace(events) -> dict:
    """Chrome ``trace_event`` JSON (the dict; ``json.dump`` it and open
    in chrome://tracing or ui.perfetto.dev).  Spans -> complete "X"
    events, instants -> "i", metric records -> counter "C" series."""
    out = []
    for ev in events:
        ts_us = float(ev.get("ts", 0.0)) * 1e6
        attrs = dict(ev.get("attrs", {}))
        kind = ev.get("kind")
        if kind == "span":
            out.append({"name": ev["name"], "ph": "X", "ts": ts_us,
                        "dur": float(ev.get("dur", 0.0)) * 1e6,
                        "pid": 0, "tid": int(attrs.pop("tid", 0)),
                        "args": attrs})
        elif kind == "metric":
            val = ev.get("value", ev.get("mean"))
            if isinstance(val, (int, float)) and val == val:
                out.append({"name": ev["name"], "ph": "C", "ts": ts_us,
                            "pid": 0, "args": {"value": float(val)}})
        else:
            out.append({"name": ev["name"], "ph": "i", "ts": ts_us,
                        "s": "t", "pid": 0, "tid": 0, "args": attrs})
    out.sort(key=lambda e: (e["ts"], e["name"]))
    return {"traceEvents": out, "displayTimeUnit": "ms"}
