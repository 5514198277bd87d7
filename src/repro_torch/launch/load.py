"""Serve-under-load launcher: seeded traffic -> slot-pool server ->
SLO report — the port of ``repro/launch/load.py`` (docs/serving.md).

Drives one server of ``repro_torch.launch.serve`` (LM or streaming ASR,
picked by the arch family; ``--cache paged`` the paged LM server)
through a deterministic :class:`repro_torch.serving.Workload` trace
with the priority-tiered admission controller, and prints the per-run
SLO summary in the shared ``name,value,derived`` CSV schema of
``launch/evaluate.py``.  Virtual time by default: the clock moves by the
cost model (``--admit-ms``, ``--wave-ms``, ``--work-us``), so the same
seed reproduces every row while the card computes every request for
real; ``--wall`` switches to wall-clock timestamps, and ``--wall`` or
``--calibrate`` measure each admission and wave and print the ``calib/*``
rows, a least-squares cost model to feed back into the three flags.

The servers run on the CUDA card (their kernels) unless ``--device cpu``
asks for the plain PyTorch path; without a card and without that flag
the launcher raises.  A measured time is host time up to a
``torch.cuda.synchronize`` taken before each stop stamp: the card's work
is queued asynchronously, and an ASR admission writes the BLSTM's
posteriors into the parked buffer with no host copy, so without the
synchronization nothing in ``submit`` would wait for the card.

Differences from the reference's flags: ``--reduced`` is opt-in (the
full width is the default, as in the port's serve CLI), and ``--device``
takes the place of ``--kernel-impl``.

PYTHONPATH=src python -m repro_torch.launch.load --arch smollm-360m \
    --reduced --device cpu --qps 2 --horizon 10 --slots 2 --max-len 32
PYTHONPATH=src python -m repro_torch.launch.load --arch swb2000-blstm \
    --reduced --device cpu --qps 1 --horizon 10 --slots 2 \
    --chunk-frames 8 --beam-width 3
PYTHONPATH=src python -m repro_torch.launch.load --arch swb2000-blstm \
    --qps 20 --horizon 3 --slots 4 --max-len 256 --len-median 150 \
    --wall --trace-out load.jsonl
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.serving import (CostModel, ServingLoop, VirtualClock,
                                 WallClock, Workload, generate_trace,
                                 make_payload, print_csv_rows,
                                 prompt_capacity, summary_rows)
from repro_torch.device import resolve_device
from repro_torch.serving.admission import OK


def instrument_server(server):
    """Wrap ``submit``/``step_wave`` with wall-time measurement: each
    admission's and wave's real service time lands in ``wall``
    histograms and in the returned observation lists, which
    :func:`repro_torch.obs.fit_cost_model` turns into calibrated
    ``CostModel`` parameters.  On the card each stop stamp follows a
    ``torch.cuda.synchronize``, so a measurement holds the card's work
    and not only its launches."""
    admit_obs, wave_obs = [], []
    orig_submit, orig_wave = server.submit, server.step_wave
    cuda = server.device.type == "cuda"

    def stop(t0):
        if cuda:
            torch.cuda.synchronize(server.device)
        return time.perf_counter() - t0

    def submit(req, payload):
        t0 = time.perf_counter()
        res = orig_submit(req, payload)
        dt = stop(t0)
        if res.reason == OK:
            admit_obs.append(dt)
            obs.histogram("load/admit_s", wall=True).observe(dt)
        return res

    def step_wave():
        t0 = time.perf_counter()
        out = orig_wave()
        dt = stop(t0)
        wave_obs.append((out[2], dt))       # (work, measured seconds)
        obs.histogram("load/wave_s", wall=True).observe(dt)
        return out

    server.submit, server.step_wave = submit, step_wave
    return admit_obs, wave_obs


def calibration_rows(fit: dict):
    """CostModel calibration as shared-schema CSV rows — the values
    paste straight back into ``--admit-ms`` / ``--wave-ms`` /
    ``--work-us`` for a calibrated virtual-time run."""
    return [
        ("calib/admit_ms", fit["admit_s"] * 1e3,
         "measured mean admission service time (feed to --admit-ms)"),
        ("calib/wave_ms", fit["wave_base_s"] * 1e3,
         "fit intercept: base cost per wave (feed to --wave-ms)"),
        ("calib/work_us", fit["per_work_s"] * 1e6,
         "fit slope: per token/frame (feed to --work-us)"),
        ("calib/n_waves", fit["n_waves"], "measured decode waves"),
        ("calib/resid_ms", fit["resid_s"] * 1e3,
         "rms residual of the wave-time fit"),
    ]


def build_server(cfg, args, device):
    """The slot-pool server for this arch family plus its payload mode;
    weights from seed 0 on ``device``."""
    from repro_torch.launch.serve import (AsrServer, PagedServer, Server,
                                          require_weights_fit)
    from repro_torch.models import build_model
    from repro_torch.serving.kvpool import cdiv

    if cfg.family == "lstm":
        server = AsrServer(
            cfg, slots=args.slots, max_frames=args.max_len,
            chunk=args.chunk_frames, beam=args.beam_width, device=device,
            topc=None if args.beam_topc < 0 else args.beam_topc)
        return server, "asr"
    require_weights_fit(build_model(cfg), device)
    if (args.cache or cfg.cache_mode) == "paged":
        page = args.page_size or cfg.page_size
        pool_pages = args.pool_pages or args.slots * cdiv(args.max_len,
                                                          page)
        server = PagedServer(cfg, pool_pages=pool_pages, page_size=page,
                             max_len=args.max_len, device=device)
        return server, "lm"
    server = Server(cfg, slots=args.slots, max_len=args.max_len,
                    device=device)
    return server, "lm"


def build_workload(args, mode: str) -> Workload:
    tier_probs = tuple(float(p) for p in args.tier_probs.split(","))
    # payload lengths capped so every offered request is admissible
    # (prompt_capacity: the LM/ASR off-by-one contract in one place)
    len_max = prompt_capacity(args.max_len, mode)
    return Workload(
        qps=args.qps, horizon=args.horizon, seed=args.seed,
        tier_probs=tier_probs, len_median=args.len_median,
        len_sigma=args.len_sigma, len_min=1, len_max=len_max,
        diurnal_amp=args.diurnal_amp, diurnal_period=args.diurnal_period,
        patience=args.patience, deadline=args.deadline,
        max_new=args.max_new)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's smoke-test width (2 layers, "
                         "d_model <= 256, vocab <= 512; lstm: hidden 64); "
                         "default: full width")
    ap.add_argument("--qps", type=float, default=2.0,
                    help="mean offered arrival rate (requests per "
                         "virtual second)")
    ap.add_argument("--horizon", type=float, default=10.0,
                    help="offered-traffic window in virtual seconds")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed: same seed => identical trace, "
                         "payloads and SLO rows")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=32,
                    help="cache capacity (LM) / max utterance frames "
                         "(ASR) per slot; payload lengths are capped to "
                         "fit")
    ap.add_argument("--max-new", type=int, default=8,
                    help="LM decode budget per request")
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="ASR frames decoded per wave")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="ASR beam width (0 = cfg beam_width)")
    ap.add_argument("--beam-topc", type=int, default=-1,
                    help="ASR per-frame top-C vocab pruning "
                         "(0 off, -1 cfg)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--cache", default="",
                    choices=["", "dense", "paged"],
                    help="LM KV-cache layout: dense slot rows or the "
                         "paged page-pool server (default: "
                         "cfg.cache_mode)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="positions per KV page under --cache paged "
                         "(0 = cfg.page_size)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical pages in the paged pool (0 = slots * "
                         "max_len / page_size, the dense-equivalent "
                         "memory)")
    ap.add_argument("--tier-probs", default="0.25,0.75",
                    help="comma list of priority-tier draw probabilities "
                         "(tier 0 = highest; preempts lower tiers)")
    ap.add_argument("--diurnal-amp", type=float, default=0.0,
                    help="diurnal rate modulation amplitude in [0, 1)")
    ap.add_argument("--diurnal-period", type=float, default=60.0,
                    help="virtual seconds per diurnal cycle")
    ap.add_argument("--len-median", type=float, default=12.0,
                    help="lognormal median payload length")
    ap.add_argument("--len-sigma", type=float, default=0.5,
                    help="lognormal log-std of payload length")
    ap.add_argument("--patience", type=float, default=30.0,
                    help="queue wait after which an unstarted request "
                         "abandons (virtual s)")
    ap.add_argument("--deadline", type=float, default=60.0,
                    help="final-result SLO bound for the deadline-miss "
                         "row (virtual s)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable slot preemption (tiers still order "
                         "the queue)")
    ap.add_argument("--wall", action="store_true",
                    help="wall-clock timestamps instead of the virtual "
                         "cost model (real measurements, not seeded-"
                         "reproducible)")
    ap.add_argument("--admit-ms", type=float, default=20.0,
                    help="virtual admission (prefill/forward) service "
                         "time, ms")
    ap.add_argument("--wave-ms", type=float, default=10.0,
                    help="virtual base cost per decode wave, ms")
    ap.add_argument("--work-us", type=float, default=0.0,
                    help="virtual cost per token decoded / frame "
                         "consumed, us")
    ap.add_argument("--min-done-per-tier", type=int, default=0,
                    help="exit nonzero unless every tier completes at "
                         "least this many requests (CI smoke gate)")
    ap.add_argument("--events", action="store_true",
                    help="print the structured per-request event stream "
                         "(offer/done with timestamps)")
    ap.add_argument("--trace-out", default="",
                    help="enable observability and write the run's "
                         "flight-recorder JSONL here (request events, "
                         "measured service times, calibration inputs; "
                         "docs/observability.md)")
    ap.add_argument("--trace-deterministic", action="store_true",
                    help="strip wall-clock fields from the JSONL so "
                         "two seeded runs emit byte-identical traces")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure real submit/step_wave service times "
                         "and print calib/* rows: a least-squares "
                         "CostModel fit whose values feed back into "
                         "--admit-ms/--wave-ms/--work-us (implied by "
                         "--wall)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace_out:
        obs.configure()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    server, mode = build_server(cfg, args, device)
    calibrate = args.wall or args.calibrate
    admit_obs = wave_obs = None
    if calibrate:
        admit_obs, wave_obs = instrument_server(server)
    workload = build_workload(args, mode)
    trace = generate_trace(workload)
    print(f"[load] {mode} on {device}: {len(trace)} offered "
          f"requests over {args.horizon:.3g}s at {args.qps:.3g} qps "
          f"({'wall' if args.wall else 'virtual'} time, "
          f"preempt={'off' if args.no_preempt else 'on'})", flush=True)

    payload_fn = lambda req: make_payload(
        req, mode=mode, vocab=cfg.vocab, input_dim=cfg.input_dim,
        seed=workload.seed)
    on_event = None
    if args.events:
        on_event = lambda kind, rid, now, kw: print(
            "[event] " + " ".join(
                [f"{kind} rid={rid} t={now:.6g}"]
                + [f"{k}={v}" for k, v in kw.items()]), flush=True)
    loop = ServingLoop(
        server, trace, payload_fn, n_tiers=len(workload.tier_probs),
        clock=WallClock() if args.wall else VirtualClock(),
        cost=CostModel(admit_s=args.admit_ms * 1e-3,
                       wave_base_s=args.wave_ms * 1e-3,
                       per_work_s=args.work_us * 1e-6),
        preempt=not args.no_preempt, on_event=on_event)
    loop.run()
    summary = loop.summary()

    derived = "wall s" if args.wall else "virtual s"
    rows = [("load/qps_offered", workload.qps, "requests per s"),
            ("load/waves", loop.n_waves, "decode waves"),
            ("load/elapsed_s", loop.clock.now(), derived)]
    rows += summary_rows(summary, "load", derived)
    if calibrate:
        rows += calibration_rows(obs.fit_cost_model(wave_obs, admit_obs))
    print_csv_rows(rows, header=True)
    if args.trace_out:
        n = obs.dump(args.trace_out,
                     deterministic=args.trace_deterministic)
        print(f"trace: {n} events -> {args.trace_out}")
        obs.reset()

    if args.min_done_per_tier > 0:
        short = {t: tv["done"] for t, tv in summary["per_tier"].items()
                 if tv["done"] < args.min_done_per_tier}
        if short:
            print(f"[load] FAIL: tiers below --min-done-per-tier="
                  f"{args.min_done_per_tier}: {short}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
