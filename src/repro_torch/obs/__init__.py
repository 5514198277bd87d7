"""repro_torch.obs — the unified observability layer (docs/observability.md).

One process-wide pair of sinks that every surface emits through:

* a :class:`~repro_torch.obs.metrics.MetricsRegistry` of tagged counters /
  gauges / histograms (per-step training scalars, serving service
  times, kernel VMEM accounting, bytes on wire), and
* a :class:`~repro_torch.obs.trace.FlightRecorder` — a bounded ring of
  schema events (spans, instants, metric snapshots) exportable as
  JSONL and as Chrome ``trace_event`` JSON.

The default is the **no-op pair**: until :func:`configure` is called
(the launchers call it when ``--trace-out`` is passed) every
instrument and span is a shared do-nothing object, so uninstrumented
runs pay one method call per site and stay bit-identical — the
property the recovery / transport-golden / paged≡dense exactness
tests rely on (gated by ``benchmarks/run.py --only obs`` at ≤ 3%
step overhead).

Module-level helpers (:func:`event`, :func:`span`, :func:`metric_*`)
always dispatch through the *current* sinks, so call sites never cache
a stale registry across :func:`configure`/:func:`reset`.

This module is also the single source of the ``name,value,derived``
stats CSV schema (:func:`csv_row` / :func:`print_csv_rows`), formerly
in ``repro_torch.serving.slo`` (which keeps deprecation shims).
"""
from __future__ import annotations

import json

from .metrics import (  # noqa: F401  (re-exports)
    MAX_SAMPLES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NOOP,
    NULL_METRICS,
    NullRegistry,
    nearest_rank,
)
from .trace import (  # noqa: F401
    DEFAULT_MAXLEN,
    FlightRecorder,
    KINDS,
    NULL_RECORDER,
    NullRecorder,
    chrome_trace,
    read_jsonl,
    validate_events,
    write_jsonl,
)
from .profile import (  # noqa: F401
    ProfiledFn,
    fit_cost_model,
    profiled,
)

# ---------------------------------------------------------------------------
# process-global sinks (no-op until configure())
# ---------------------------------------------------------------------------

_metrics: MetricsRegistry = NULL_METRICS
_recorder: FlightRecorder = NULL_RECORDER


def configure(maxlen: int = DEFAULT_MAXLEN):
    """Turn observability on: install a live registry + recorder pair
    (replacing the no-op defaults) and return ``(metrics, recorder)``."""
    global _metrics, _recorder
    _metrics = MetricsRegistry()
    _recorder = FlightRecorder(maxlen=maxlen)
    return _metrics, _recorder


def reset() -> None:
    """Back to the zero-overhead no-op defaults (tests; end of a run)."""
    global _metrics, _recorder
    _metrics = NULL_METRICS
    _recorder = NULL_RECORDER


def enabled() -> bool:
    return _metrics is not NULL_METRICS


def get_metrics() -> MetricsRegistry:
    return _metrics


def get_recorder() -> FlightRecorder:
    return _recorder


# thin always-current dispatchers (never cache the sink at a call site)

def event(name: str, **attrs) -> None:
    _recorder.event(name, **attrs)


def span(name: str, **attrs):
    return _recorder.span(name, **attrs)


def add_span(name: str, t0: float, dur: float, **attrs) -> None:
    _recorder.add_span(name, t0, dur, **attrs)


def counter(name: str, **tags):
    return _metrics.counter(name, **tags)


def gauge(name: str, **tags):
    return _metrics.gauge(name, **tags)


def histogram(name: str, wall: bool = False, **tags):
    return _metrics.histogram(name, wall=wall, **tags)


def flush_metrics() -> int:
    """Append the registry snapshot to the flight recorder as
    ``metric`` events (deterministic order); returns records written."""
    recs = _metrics.snapshot()
    for rec in recs:
        _recorder.metric(rec)
    return len(recs)


def dump(path: str, deterministic: bool = False,
         chrome: str = None) -> int:
    """Flush the metrics snapshot and write the recorder to ``path`` as
    JSONL (optionally also ``chrome`` as trace_event JSON); returns
    JSONL lines written.  No-op (returns 0) while disabled."""
    if not enabled():
        return 0
    flush_metrics()
    events_ = _recorder.events
    n = write_jsonl(events_, path, deterministic=deterministic)
    if chrome:
        with open(chrome, "w", encoding="utf-8") as f:
            json.dump(chrome_trace(events_), f)
    return n


# ---------------------------------------------------------------------------
# the shared ``name,value,derived`` stats CSV schema
# (moved here from repro_torch.serving.slo — single formatting source)
# ---------------------------------------------------------------------------

CSV_HEADER = "name,value,derived"


def csv_row(name, value, derived="") -> str:
    """One row of the shared stats schema (evaluate/benchmarks/load)."""
    try:
        value = f"{float(value):.6g}"
    except (TypeError, ValueError):
        value = str(value)
    return f"{name},{value},{derived}"


def print_csv_rows(rows, header: bool = False) -> None:
    """Print ``(name, value, derived)`` rows in the shared schema."""
    if header:
        print(CSV_HEADER)
    for name, value, derived in rows:
        print(csv_row(name, value, derived), flush=True)
