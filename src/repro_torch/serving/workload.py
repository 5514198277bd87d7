"""Seeded, fully deterministic load generator for the serving layer.

The traffic model mirrors what a fleet front-end sees (docs/serving.md):

* **Arrivals** — a Poisson process at ``qps``, optionally modulated by a
  diurnal cycle: the instantaneous rate is ``rate_at(w, t) = qps * (1 +
  amp * sin(2*pi*t / period))``.  Modulated arrivals are drawn by
  *thinning* a homogeneous process at the peak rate ``qps * (1 + amp)``,
  so the trace is exact for any amplitude in [0, 1).
* **Lengths** — lognormal utterance frames / prompt tokens (the same
  family ``repro_torch.data.pipeline`` uses for the ``lengths`` batch
  contract), clipped to ``[len_min, len_max]``.
* **Tiers** — each request draws a priority tier from ``tier_probs``
  (tier 0 is the highest priority; the admission controller may preempt
  lower tiers for it).
* **Deadline + abandonment** — ``patience`` bounds how long a request
  waits in the queue before its user walks away (it abandons *unstarted*
  only); ``deadline`` is the final-result SLO used for accounting.

Everything is a pure function of ``(Workload, seed)``: the same config
produces the identical arrival/length/tier trace, which is what makes
the capacity report of ``benchmarks/run.py --only load`` reproducible
row-for-row.  Draw order is fixed (gap, thinning coin, then length and
tier for accepted arrivals) so the trace is stable under refactors that
do not change the model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One offered request of the trace (virtual-seconds timestamps)."""

    rid: int
    arrival: float        # virtual s from trace start
    length: int           # prompt tokens (LM) / utterance frames (ASR)
    tier: int             # 0 = highest priority
    max_new: int          # LM decode budget (ASR ignores it)
    patience: float       # abandon if not admitted within this wait
    deadline: float       # final-result SLO bound (accounting only)


@dataclass(frozen=True)
class Workload:
    """Deterministic traffic model; see the module docstring."""

    qps: float
    horizon: float                 # generate arrivals in [0, horizon)
    seed: int = 0
    tier_probs: Tuple[float, ...] = (0.25, 0.75)
    len_median: float = 12.0       # lognormal median length
    len_sigma: float = 0.5         # lognormal log-std
    len_min: int = 1
    len_max: int = 48
    diurnal_amp: float = 0.0       # 0 = homogeneous Poisson
    diurnal_period: float = 60.0   # virtual s per diurnal cycle
    patience: float = 30.0
    deadline: float = 60.0
    max_new: int = 8

    def with_qps(self, qps: float) -> "Workload":
        return replace(self, qps=qps)


def rate_at(w: Workload, t: float) -> float:
    """Instantaneous arrival rate at virtual time ``t`` (requests/s).

    Monotone in ``diurnal_amp``: increasing at phases where
    ``sin(2*pi*t/period) > 0``, decreasing where it is negative, and the
    peak/trough rates are ``qps * (1 +- amp)`` exactly.
    """
    if w.diurnal_amp == 0.0:
        return w.qps
    return w.qps * (1.0 + w.diurnal_amp
                    * math.sin(2.0 * math.pi * t / w.diurnal_period))


def generate_trace(w: Workload) -> list:
    """The full request trace as a list of :class:`Request`, sorted by
    arrival.  Same ``Workload`` (incl. seed) => identical trace."""
    if not 0.0 <= w.diurnal_amp < 1.0:
        raise ValueError(f"diurnal_amp must be in [0, 1), got {w.diurnal_amp}")
    if w.qps <= 0.0 or w.horizon <= 0.0:
        raise ValueError("qps and horizon must be positive")
    probs = np.asarray(w.tier_probs, np.float64)
    if probs.ndim != 1 or len(probs) == 0 or (probs < 0).any():
        raise ValueError(f"bad tier_probs {w.tier_probs}")
    probs = probs / probs.sum()
    cum = np.cumsum(probs)

    rng = np.random.default_rng(w.seed)
    lam_max = w.qps * (1.0 + w.diurnal_amp)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= w.horizon:
            break
        # thinning: keep the point with prob rate(t) / lam_max
        if rng.random() * lam_max > rate_at(w, t):
            continue
        length = int(np.clip(
            round(float(rng.lognormal(math.log(w.len_median), w.len_sigma))),
            w.len_min, w.len_max))
        tier = int(np.searchsorted(cum, rng.random(), side="right"))
        tier = min(tier, len(cum) - 1)
        out.append(Request(rid=len(out), arrival=float(t), length=length,
                           tier=tier, max_new=w.max_new,
                           patience=w.patience, deadline=w.deadline))
    return out


def make_payload(req: Request, *, mode: str, vocab: int = 0,
                 input_dim: int = 0, seed: int = 0) -> np.ndarray:
    """Deterministic request payload: LM prompt tokens or ASR features.

    Seeded per ``(seed, rid)`` so a preempted-and-resumed request and an
    uninterrupted replay of the same trace see identical bytes.
    """
    rng = np.random.default_rng((seed, req.rid))
    if mode == "lm":
        if vocab <= 0:
            raise ValueError("lm payloads need vocab > 0")
        return rng.integers(0, vocab, size=req.length).astype(np.int32)
    if mode == "asr":
        if input_dim <= 0:
            raise ValueError("asr payloads need input_dim > 0")
        return rng.normal(size=(req.length, input_dim)).astype(np.float32)
    raise ValueError(f"mode must be 'lm' or 'asr', got {mode!r}")
