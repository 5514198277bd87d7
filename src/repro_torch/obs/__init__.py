"""Observability of the port: so far only the shared ``name,value,derived``
stats CSV schema that evaluate prints, own copies of
``repro.obs.CSV_HEADER``, ``csv_row`` and ``print_csv_rows``.  The
metrics registry and the span recorder are not ported yet (ROADMAP.md,
queue 1, "Observability")."""
from __future__ import annotations

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
