"""Profiling hooks: compile-vs-steady wall-time wrappers for the port's
entry points, and the CostModel calibration fit fed by them.

The port's own copy of ``repro/obs/profile.py``.  A first call costs
more than the calls after it: the first call of an entry point for a
given input shape also pays the CUDA context's and the libraries'
warm-up, the allocator's growth and the build of any kernel not built
yet (``nvcc`` into ``build/torch_kernels/``).  :class:`ProfiledFn`
wraps a callable, blocks on its result (``torch.cuda.synchronize``: the
launches are asynchronous, so the host clock reads the card's work only
up to a synchronization) and classifies each call:

* **compile** — first call for a given *shape key* (by default the
  shapes/dtypes of array arguments).  The phase keeps the reference's
  name, which ``launch/obsreport.py`` keys on; here it means the first
  call per shape key, warm-up and kernel builds included,
* **steady** — every subsequent call with a known key.

Timings land in the process metrics registry as ``wall=True``
histograms tagged ``fn=<name> phase=compile|steady`` and, optionally,
as flight-recorder spans — so ``launch/obsreport.py`` renders the
split and the deterministic JSONL export can drop them.  Each wrapped
call synchronizes the card, so a profiled run is timed with one more
synchronization per call than an unprofiled one.

:func:`fit_cost_model` closes the loop "calibrate CostModel from
``--wall`` runs": a least-squares line through measured (work, wave
seconds) pairs gives ``per_work_s``/``wave_base_s``, and mean admit time
gives ``admit_s`` — printable as CSV and pastable back into
``launch/load.py`` flags.
"""
from __future__ import annotations

import time

from .metrics import NULL_METRICS
from .trace import NULL_RECORDER

def _block(x):
    """Wait for the card's queued work (torch is imported here, so obs
    and obsreport import without it); a no-op without CUDA."""
    try:
        import torch
    except ImportError:          # pragma: no cover - obs without torch
        return x
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


def _shape_key(args, kwargs):
    """Default shape key: the (shape, dtype) of every array-like
    argument — a new batch shape is a first call again (new buffers, a
    new launch plan)."""
    parts = []
    for a in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        shape = getattr(a, "shape", None)
        if shape is not None:
            parts.append((tuple(shape), str(getattr(a, "dtype", ""))))
    return tuple(parts)


class ProfiledFn:
    """Wall-time wrapper separating first-call (compile) from
    steady-state time per entry point.

    >>> step = ProfiledFn(train_step, "train/step")
    >>> out = step(state, batch)        # blocked; timed as compile
    >>> out = step(state, batch)        # timed as steady
    >>> step.compile_s, step.steady_s, step.n_compiles
    """

    def __init__(self, fn, name: str, *, metrics=None, recorder=None,
                 key=None, block=True):
        self.fn = fn
        self.name = name
        self.metrics = NULL_METRICS if metrics is None else metrics
        self.recorder = NULL_RECORDER if recorder is None else recorder
        self._key = _shape_key if key is None else key
        self._block = block
        self._seen: set = set()
        self.n_calls = 0
        self.n_compiles = 0
        self.compile_s = 0.0
        self.steady_s = 0.0

    def __call__(self, *args, **kwargs):
        k = self._key(args, kwargs)
        compile_call = k not in self._seen
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self._block:
            out = _block(out)
        dt = time.perf_counter() - t0
        self._seen.add(k)
        self.n_calls += 1
        phase = "compile" if compile_call else "steady"
        if compile_call:
            self.n_compiles += 1
            self.compile_s += dt
        else:
            self.steady_s += dt
        self.metrics.histogram("profile/call_s", wall=True,
                               fn=self.name, phase=phase).observe(dt)
        self.recorder.add_span(self.name, t0, dt, phase=phase, wall=True)
        return out

    @property
    def steady_mean_s(self) -> float:
        n = self.n_calls - self.n_compiles
        return self.steady_s / n if n else float("nan")

    def summary(self) -> dict:
        return {"fn": self.name, "n_calls": self.n_calls,
                "n_compiles": self.n_compiles,
                "compile_s": self.compile_s, "steady_s": self.steady_s,
                "steady_mean_s": self.steady_mean_s}


def profiled(fn, name: str, **kw) -> ProfiledFn:
    """Wrap ``fn`` unless it already is a :class:`ProfiledFn`."""
    if isinstance(fn, ProfiledFn):
        return fn
    return ProfiledFn(fn, name, **kw)


# ---------------------------------------------------------------------------
# CostModel calibration from measured service times
# ---------------------------------------------------------------------------

def fit_cost_model(wave_obs, admit_obs=()) -> dict:
    """Least-squares CostModel parameters from ``--wall`` measurements.

    ``wave_obs`` — iterable of ``(work, seconds)`` pairs, one per
    measured ``step_wave`` (work = active decode slots, the CostModel's
    unit); ``admit_obs`` — measured per-admission seconds.  Returns a
    plain dict (NOT a CostModel — keeps obs import-free of serving)::

        {"wave_base_s", "per_work_s", "admit_s", "n_waves", "resid_s"}

    With a single distinct work level the slope is unidentifiable; we
    pin ``per_work_s = 0`` and fit the intercept alone.
    """
    pairs = [(float(w), float(s)) for w, s in wave_obs]
    n = len(pairs)
    if n == 0:
        return {"wave_base_s": float("nan"), "per_work_s": float("nan"),
                "admit_s": _mean(admit_obs), "n_waves": 0,
                "resid_s": float("nan")}
    xs = [w for w, _ in pairs]
    ys = [s for _, s in pairs]
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx > 0.0:
        slope = sum((x - mx) * (y - my) for x, y in pairs) / sxx
        slope = max(slope, 0.0)  # negative per-work cost is noise
    else:
        slope = 0.0
    base = max(my - slope * mx, 0.0)
    resid = (sum((y - (base + slope * x)) ** 2
                 for x, y in pairs) / n) ** 0.5
    return {"wave_base_s": base, "per_work_s": slope,
            "admit_s": _mean(admit_obs), "n_waves": n, "resid_s": resid}


def _mean(vals) -> float:
    vals = [float(v) for v in vals]
    return sum(vals) / len(vals) if vals else float("nan")
