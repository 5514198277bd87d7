"""Render a flight-recorder JSONL trace into a human-readable report
(docs/observability.md §Reading a trace).

Reads the ``--trace-out`` JSONL of any launcher (train / serve / load /
evaluate), validates it against the shared event schema (exit 1 on a
violation — the CI obs smoke gates on this), and prints:

* the per-span-name time breakdown (count, total, *self* time with
  child spans attributed to their parents via ``id``/``parent``),
* the compile-vs-steady split of every profiled jit entry point,
* counter / gauge values (bytes on wire per strategy, kernel VMEM
  accounting) and histogram percentiles,
* request outcome counts and latency percentiles, rebuilt from the
  ``request/*`` instants via
  :func:`repro_torch.serving.slo.fold_request_events`.

``--chrome OUT`` additionally converts the trace to Chrome
``trace_event`` JSON (open in chrome://tracing or ui.perfetto.dev);
``--csv`` emits the report in the shared ``name,value,derived`` schema
instead of the text tables.

PYTHONPATH=src python -m repro_torch.launch.obsreport /tmp/train.jsonl
PYTHONPATH=src python -m repro_torch.launch.obsreport /tmp/serve.jsonl \
    --chrome /tmp/serve_chrome.json --top 20
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict

from repro_torch.obs import chrome_trace, print_csv_rows, read_jsonl, \
    validate_events
from repro_torch.serving.slo import fold_request_events, summarize

_PHASES = ("compile", "steady")


def span_table(events):
    """Per-span-name rows ``(name, count, total_s, self_s)`` sorted by
    self time (descending).  Self time subtracts each direct child's
    duration from its parent (``id``/``parent`` linkage); a
    deterministic trace has no ``dur`` fields, so totals are 0 and the
    table degrades to counts."""
    spans = [ev for ev in events if ev.get("kind") == "span"]
    child = defaultdict(float)
    for ev in spans:
        if ev.get("parent"):
            child[ev["parent"]] += float(ev.get("dur", 0.0))
    per = {}
    for ev in spans:
        dur = float(ev.get("dur", 0.0))
        row = per.setdefault(ev["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur
        row[2] += dur - child.get(ev.get("id"), 0.0)
    rows = [(name, n, tot, slf) for name, (n, tot, slf) in per.items()]
    rows.sort(key=lambda r: (-r[3], r[0]))
    return rows


def compile_steady(events):
    """``fn -> phase -> (n_calls, total_s)`` for every profiled jit
    entry point: from the ProfiledFn wall spans (which carry a
    ``phase`` attr) when present, else from the ``profile/call_s``
    metric snapshot.  Empty when the trace was exported
    deterministically (wall records are dropped)."""
    out = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for ev in events:
        attrs = ev.get("attrs", {})
        if ev.get("kind") == "span" and attrs.get("phase") in _PHASES:
            cell = out[ev["name"]][attrs["phase"]]
            cell[0] += 1
            cell[1] += float(ev.get("dur", 0.0))
    if out:
        return out
    for ev in events:
        if ev.get("kind") == "metric" and ev.get("name") == "profile/call_s":
            tags = ev.get("tags", {})
            if tags.get("phase") in _PHASES:
                cell = out[tags.get("fn", "?")][tags["phase"]]
                cell[0] += int(ev.get("count", 0))
                cell[1] += float(ev.get("total", 0.0))
    return out


def _tagstr(tags: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(tags.items())) or "-"


def _fmt_s(v: float) -> str:
    return f"{v:9.4f}s" if v == v else "      nan"


def render_text(events, path: str, top: int) -> None:
    kinds = defaultdict(int)
    for ev in events:
        kinds[ev.get("kind")] += 1
    deterministic = not any("ts" in ev for ev in events)
    mode = "deterministic (wall-clock fields stripped)" \
        if deterministic else "wall-clock"
    print(f"== {path}: {len(events)} events "
          f"({', '.join(f'{kinds[k]} {k}' for k in sorted(kinds))}; "
          f"{mode}) ==")

    rows = span_table(events)
    if rows:
        print("\n-- span time breakdown (self-sorted) --")
        print(f"{'span':<28}{'count':>7}{'total':>11}{'self':>11}")
        for name, n, tot, slf in rows[:top]:
            print(f"{name:<28}{n:>7}{_fmt_s(tot):>11}{_fmt_s(slf):>11}")
        if len(rows) > top:
            print(f"... {len(rows) - top} more (raise --top)")

    prof = compile_steady(events)
    if prof:
        print("\n-- compile vs steady (profiled jit entry points) --")
        for fn in sorted(prof):
            parts = []
            for phase in _PHASES:
                n, tot = prof[fn][phase]
                if n:
                    mean = tot / n
                    parts.append(f"{phase} {tot:.3f}s over {n} call(s) "
                                 f"({mean * 1e3:.1f} ms/call)")
            print(f"{fn:<28}" + "; ".join(parts))
    elif deterministic:
        print("\n-- compile vs steady: dropped by the deterministic "
              "export (re-run without --trace-deterministic) --")

    metrics = [ev for ev in events if ev.get("kind") == "metric"]
    cg = [ev for ev in metrics if ev.get("instrument") in ("counter",
                                                           "gauge")]
    if cg:
        print("\n-- counters / gauges --")
        for ev in cg:
            print(f"{ev['name']:<28}{ev.get('value', math.nan):>14.6g}  "
                  f"[{ev.get('instrument')}] {_tagstr(ev.get('tags', {}))}")
    hists = [ev for ev in metrics if ev.get("instrument") == "histogram"]
    if hists:
        print("\n-- histograms --")
        print(f"{'name':<28}{'count':>7}{'mean':>12}{'p50':>12}"
              f"{'p95':>12}{'p99':>12}  tags")
        for ev in hists[:top]:
            print(f"{ev['name']:<28}{ev.get('count', 0):>7}"
                  + "".join(f"{ev.get(f, math.nan):>12.4g}"
                            for f in ("mean", "p50", "p95", "p99"))
                  + f"  {_tagstr(ev.get('tags', {}))}")

    if any(ev.get("kind") == "event"
           and str(ev.get("name", "")).startswith("request/")
           for ev in events):
        s = summarize(fold_request_events(events))
        print("\n-- requests (folded from request/* events) --")
        print(f"offered {s['offered']}  done {s['done']}  "
              f"abandoned {s['abandoned']}  rejected {s['rejected']}  "
              f"preemptions {s['preemptions']}  tokens {s['tokens']}")
        for m in ("queue_wait", "first_token", "final"):
            pct = s[m]
            print(f"{m:<14}" + "  ".join(
                f"{q}={pct[q]:.4g}s" for q in ("p50", "p95", "p99")))


def report_rows(events):
    """The report as shared-schema ``(name, value, derived)`` rows
    (``--csv``; also what the CI smoke parses).  Metric tags are folded
    into the name as ``name[k=v ...]`` to keep one row per instrument."""
    rows = [("trace/events", len(events), "flight-recorder records")]
    kinds = defaultdict(int)
    for ev in events:
        kinds[ev.get("kind")] += 1
    rows += [(f"trace/kind/{k}", n, "") for k, n in sorted(kinds.items())]
    for name, n, tot, slf in span_table(events):
        rows.append((f"span/{name}", tot,
                     f"total s over {n} span(s), self {slf:.6g}s"))
    for fn, phases in sorted(compile_steady(events).items()):
        for phase in _PHASES:
            n, tot = phases[phase]
            if n:
                rows.append((f"profile/{fn}/{phase}_s", tot,
                             f"{n} call(s)"))
    for ev in events:
        if ev.get("kind") != "metric":
            continue
        tags = ev.get("tags", {})
        name = ev["name"] + (f"[{_tagstr(tags)}]" if tags else "")
        if ev.get("instrument") in ("counter", "gauge"):
            rows.append((name, ev.get("value", math.nan),
                         ev.get("instrument")))
        elif ev.get("instrument") == "histogram":
            rows.append((f"{name}/mean", ev.get("mean", math.nan),
                         f"histogram over {ev.get('count', 0)} obs"))
    if any(ev.get("kind") == "event"
           and str(ev.get("name", "")).startswith("request/")
           for ev in events):
        s = summarize(fold_request_events(events))
        rows += [(f"request/{k}", float(s[k]), "")
                 for k in ("offered", "done", "abandoned", "rejected",
                           "preemptions", "tokens")]
        for m in ("queue_wait", "first_token", "final"):
            for q, v in s[m].items():
                rows.append((f"request/{m}_{q}", v, "s"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render a flight-recorder JSONL trace "
                    "(docs/observability.md)")
    ap.add_argument("trace",
                    help="JSONL written by a launcher's --trace-out")
    ap.add_argument("--chrome", default="",
                    help="also write Chrome trace_event JSON here "
                         "(open in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--csv", action="store_true",
                    help="emit the report as name,value,derived rows "
                         "(the shared stats schema) instead of text "
                         "tables")
    ap.add_argument("--top", type=int, default=12,
                    help="max rows per text table")
    args = ap.parse_args(argv)

    events = read_jsonl(args.trace)
    problems = validate_events(events)
    if problems:
        for p in problems[:20]:
            print(f"[obsreport] schema: {p}", file=sys.stderr)
        print(f"[obsreport] FAIL: {len(problems)} schema problem(s) in "
              f"{args.trace}", file=sys.stderr)
        return 1

    if args.csv:
        print_csv_rows(report_rows(events), header=True)
    else:
        render_text(events, args.trace, args.top)
    if args.chrome:
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump(chrome_trace(events), f)
        print(f"chrome trace -> {args.chrome}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
