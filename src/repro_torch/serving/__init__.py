"""Multi-tenant serving layer: deterministic load generation, SLO-
accounted continuous batching with priority preemption, and a
closed-loop capacity search (docs/serving.md).

The package is server-agnostic: it drives the slot-pool servers of
``repro_torch.launch.serve`` (LM and streaming ASR) through a shared duck
contract — ``submit`` / ``step_wave`` / ``preempt`` / ``restore`` /
``reset`` — so queueing, preemption and latency accounting are written
once.  Everything runs in *virtual time* by default (no wall-clock
sleeps; reproducible in tests), with a wall-clock mode for benches.
"""
from repro_torch.serving.admission import (NO_BUDGET, OK, POOL_FULL,   # noqa: F401
                                     PROMPT_TOO_LONG, AdmissionController,
                                     AdmitResult, Job, prompt_capacity)
from repro_torch.serving.capacity import (run_level,                   # noqa: F401
                                    sustained_capacity)
from repro_torch.serving.kvpool import PageAlloc, PagePool             # noqa: F401
from repro_torch.serving.loop import (CostModel, ServingLoop,          # noqa: F401
                                VirtualClock, WallClock)
from repro_torch.serving.slo import (Recorder, RequestEvents,          # noqa: F401
                               csv_row, percentile, print_csv_rows,
                               summarize, summary_rows)
from repro_torch.serving.workload import (Request, Workload,           # noqa: F401
                                    generate_trace, make_payload, rate_at)
