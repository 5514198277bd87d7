"""Metrics registry: counters, gauges and histograms with tag support.

One process-wide registry (held by ``repro_torch.obs``) collects every
per-step scalar the launchers used to print ad-hoc — train loss /
wire bytes / pad efficiency / fault telemetry, serving service times,
kernel VMEM accounting — so one snapshot carries the whole run
(docs/observability.md).

Design contract:

* **Zero-overhead no-op default** — until ``repro_torch.obs.configure()`` is
  called, every instrument handed out is the shared :data:`NOOP`
  object whose methods do nothing; uninstrumented runs stay
  bit-identical and pay only a method-call per site.
* **Deterministic snapshot order** — :meth:`MetricsRegistry.snapshot`
  sorts by ``(name, sorted(tags))`` regardless of registration order,
  so two runs that record the same values emit byte-identical
  snapshots (property-tested in tests/test_obs.py).
* **Wall marking** — instruments created with ``wall=True`` hold
  wall-clock measurements (service times, step durations); the
  deterministic JSONL export (``repro_torch.obs.trace.write_jsonl``) drops
  them so seeded runs stay bit-equal across re-runs.
"""
from __future__ import annotations

import math

# histogram sample reservoir cap: enough for percentile fidelity on
# smoke-scale runs without unbounded memory on long ones
MAX_SAMPLES = 4096

_QS = (50, 95, 99)


def nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile (the repo-wide convention of
    repro_torch.serving.slo): element ``ceil(q/100 * n) - 1`` of the sorted
    sample; NaN on an empty one."""
    vals = sorted(values)
    if not vals:
        return float("nan")
    rank = max(int(math.ceil(q / 100.0 * len(vals))), 1)
    return vals[min(rank, len(vals)) - 1]


class Counter:
    """Monotone accumulator (bytes on wire, tokens decoded, ...)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)

    def fields(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-written value (occupancy, VMEM accounting, pad efficiency)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def fields(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming distribution: count/total/min/max plus a bounded
    sample reservoir (first :data:`MAX_SAMPLES` observations) for
    nearest-rank percentiles and the CostModel least-squares fit."""

    __slots__ = ("count", "total", "min", "max", "samples", "wall")
    kind = "histogram"

    def __init__(self, wall: bool = False):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: list = []
        self.wall = wall

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.samples) < MAX_SAMPLES:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def fields(self) -> dict:
        out = {"count": self.count, "total": self.total, "mean": self.mean,
               "min": self.min if self.count else float("nan"),
               "max": self.max if self.count else float("nan")}
        for q in _QS:
            out[f"p{q}"] = nearest_rank(self.samples, q)
        return out


class _Noop:
    """The shared do-nothing instrument of the disabled registry: every
    method of every instrument kind, as a pass."""

    __slots__ = ()
    kind = "noop"
    value = 0.0
    count = 0
    total = 0.0
    mean = float("nan")
    samples: tuple = ()
    wall = False

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def fields(self) -> dict:
        return {}


NOOP = _Noop()


def _key(name: str, tags: dict):
    return (name, tuple(sorted(tags.items())))


class MetricsRegistry:
    """Tagged instrument registry with deterministic snapshots.

    ``counter/gauge/histogram(name, **tags)`` get-or-create the
    instrument for ``(name, tags)``; asking for an existing name with a
    different kind is a :class:`TypeError` (one name, one meaning)."""

    def __init__(self):
        self._items: dict = {}

    def _get(self, cls, name: str, tags: dict, **kw):
        key = _key(name, tags)
        inst = self._items.get(key)
        if inst is None:
            inst = self._items[key] = cls(**kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} {dict(tags)} already registered as "
                f"{inst.kind}, not {cls.kind}")
        return inst

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, wall: bool = False, **tags) -> Histogram:
        h = self._get(Histogram, name, tags, wall=wall)
        if wall:
            h.wall = True
        return h

    def __len__(self) -> int:
        return len(self._items)

    def snapshot(self) -> list:
        """Deterministically-ordered list of metric records:
        ``{"name", "tags", "kind", "wall", **fields}`` sorted by
        ``(name, sorted(tags))`` — independent of registration order."""
        out = []
        for key in sorted(self._items):
            name, tags = key
            inst = self._items[key]
            rec = {"name": name, "tags": dict(tags), "kind": inst.kind,
                   "wall": bool(getattr(inst, "wall", False))}
            rec.update(inst.fields())
            out.append(rec)
        return out


class NullRegistry(MetricsRegistry):
    """The disabled default: hands out :data:`NOOP` for everything and
    snapshots empty — instrumentation sites cost one no-op call."""

    def counter(self, name: str, **tags):
        return NOOP

    def gauge(self, name: str, **tags):
        return NOOP

    def histogram(self, name: str, wall: bool = False, **tags):
        return NOOP

    def snapshot(self) -> list:
        return []


NULL_METRICS = NullRegistry()
