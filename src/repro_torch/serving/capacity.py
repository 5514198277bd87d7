"""Closed-loop capacity search: bisect the max sustained QPS meeting a
p99 first-token SLO target (docs/serving.md §Capacity report).

``sustained_capacity`` replays the *same* seeded workload shape at
candidate arrival rates (``Workload.with_qps`` keeps every other knob —
seed, lengths, tiers, diurnal phase — fixed) through a real server in
virtual time, and bisects the largest rate whose run satisfies

* p99 first-token latency <= ``p99_target_s``,
* abandonment fraction   <= ``max_abandon_frac``,
* at least one completion (an empty trace is vacuously feasible).

Everything is deterministic: the trace is a pure function of
``(workload, qps)``, the loop runs on a :class:`VirtualClock`, and the
bisection itself touches only exact float midpoints — so re-running the
same seed reproduces the identical max-QPS row and latency percentiles.
One server instance is reused across probe levels via ``reset()`` so
the jitted prefill/decode executables compile once.
"""
from __future__ import annotations

import math

from repro_torch.serving.loop import CostModel, ServingLoop, VirtualClock
from repro_torch.serving.workload import Workload, generate_trace


def run_level(server, workload: Workload, payload_fn, *,
              cost: CostModel, preempt: bool = True):
    """One probe: reset the server, replay the workload's trace in
    virtual time, return the SLO summary dict."""
    server.reset()
    trace = generate_trace(workload)
    loop = ServingLoop(server, trace, payload_fn,
                       n_tiers=len(workload.tier_probs),
                       clock=VirtualClock(), cost=cost, preempt=preempt)
    loop.run()
    s = loop.summary()
    s["qps"] = workload.qps
    s["waves"] = loop.n_waves
    s["virtual_s"] = loop.clock.now()
    return s


def feasible(summary: dict, *, p99_target_s: float,
             max_abandon_frac: float = 0.05) -> bool:
    if summary["offered"] == 0:
        return True
    if summary["done"] == 0:
        return False
    p99 = summary["first_token"]["p99"]
    if math.isnan(p99) or p99 > p99_target_s:
        return False
    return summary["abandoned"] <= max_abandon_frac * summary["offered"]


def sustained_capacity(server, workload: Workload, payload_fn, *,
                       p99_target_s: float, qps_lo: float = 0.25,
                       qps_hi: float = 32.0, iters: int = 5,
                       cost: CostModel = None, preempt: bool = True,
                       max_abandon_frac: float = 0.05):
    """Bisect the max sustained QPS meeting the p99 first-token target.

    Returns ``(max_qps, summary_at_max)`` — ``max_qps`` is 0.0 (with the
    infeasible low-probe summary) when even ``qps_lo`` misses the SLO,
    and ``qps_hi`` when the whole bracket is feasible.
    """
    cost = cost if cost is not None else CostModel()
    probe = lambda q: run_level(server, workload.with_qps(q), payload_fn,
                                cost=cost, preempt=preempt)
    ok = lambda s: feasible(s, p99_target_s=p99_target_s,
                            max_abandon_frac=max_abandon_frac)
    s_lo = probe(qps_lo)
    if not ok(s_lo):
        return 0.0, s_lo
    s_hi = probe(qps_hi)
    if ok(s_hi):
        return qps_hi, s_hi
    lo, best = qps_lo, s_lo
    hi = qps_hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = probe(mid)
        if ok(s):
            lo, best = mid, s
        else:
            hi = mid
    return lo, best
