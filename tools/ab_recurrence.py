#!/usr/bin/env python3
"""Time the BLSTM kernels of one source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from
the same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_recurrence.py build/$r
    done

For each case it prints the time of one wrapper call from CUDA events
over back-to-back calls, and its device time with the host's dispatch
taken out (``chip_smoke._device_ms``: calls replayed from one CUDA
graph), and a SHA-256 of the case's outputs (y, the stash or the entry
carries, dx and the gradients), so that two trees can be seen to compute
the same bits.  Weights and inputs are drawn from seed 0.  The trees'
kernels are built into their own ``build/torch_kernels/``.  Cases:

* K1 inference at the ASR admission's shape (B = 1, T = 256);
* the fused stack K4 and the K1 loop it is bit-identical to, 6 layers at
  B = 1, 3 and 8 (a tree without K4 skips them), with K4's plan where the
  tree has ``lstm_cell.stack_plan``, and there K4 at B = 8 forced onto
  1-, 2- and 4-row tiles;
* the token selector K6 at the dense LM decode's (8, 49152) bf16 logits,
  and where its eager time goes: the host time of each part of the
  wrapper (the device check, the library lookup, the stream as a Stream
  object and as a raw handle, the output allocation, the ctypes call) and
  of ``torch.argmax``, from ``time.perf_counter_ns`` over back-to-back
  calls;
* K1-stash and K2 at the paper's training shape (16 learners x 16 rows,
  T = 21, D = 1024, H = 512, var-len), each with its sub-launches: the
  device time per call of every kernel it launches from torch.profiler
  (``lstm_xproj`` and ``blstm_recur``; ``lstm_bwd_recur``, ``lstm_bwd_dx``
  and ``lstm_bwd_dw``, the layout copies as torch ops);
* K1-chunk and K3 at the train-long layer shape (16 learners x 2 rows,
  T = 2000, K = 256, var-len), and K1-stash and K2 on the same input,
  with their sub-launches;
* end to end: the train-long step (16 learners x 2 utterances, T = 2000)
  chunked and unchunked, ms/step and peak device memory; the §V step
  (ms/step); the ASR serve of 8 requests after one warm-up serve (mean
  wave ms, frames/s); evaluate's scoring of 4 batches of 8 x 256 frames
  from freshly drawn weights (frames/s).

With ``--stages`` a tree with ``lstm_cell.recur_plan`` instead times the
recurrence cases at the train-long layer shape and at the §V shape on
each forward launch in turn, whatever the plan picks (no end-to-end
turns): the streaming launch (clusters of 2) and the resident one
(Wh in shared memory, clusters of 16); then the crossing of the two:
K1-stash's forward recurrence (the ``blstm_recur`` sub-launch, device
ms per call) on each launch at 16 learners x 1, 2 and 4 rows over 4 to
256 steps and at 16 learners x 16 rows (8-row tiles) over 21 to 256
steps, the measurement behind the rule's ``RESIDENT_MIN_STEPS`` and
``RESIDENT_MAX_ROWS``.
"""
import hashlib
import sys
import time
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (timing and input helpers)

root = sys.argv[1]
STAGES = "--stages" in sys.argv[2:]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import lstm_cell as LC  # noqa: E402

dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
name = root.rstrip("/").split("/")[-1]


def case(L, B, T, D, H, var_len=False):
    return CS._stacked_inputs(L, B, T, D, H, gen, var_len)


def device_ms(fn, iters):
    return CS._device_ms(fn, iters=iters, reps=2) or 0.0


def digest(out) -> str:
    """SHA-256 (first 16 hex digits) of a nest of tensors' bytes."""
    h = hashlib.sha256()

    def add(t):
        if isinstance(t, (list, tuple)):
            for u in t:
                add(u)
        elif t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    add(out)
    return h.hexdigest()[:16]


def report(label, fn, iters, extra="", device=True):
    dev_ms = f"  device {device_ms(fn, iters):9.3f} ms" if device else ""
    print(f"{name:8s} {label:34s} event {CS._time_ms(fn, iters):9.3f} ms"
          f"{dev_ms}  sha256 {digest(fn())}{extra}", flush=True)


def sublaunches(label, fn, calls):
    """Device ms per call of each sub-launch of ``fn`` (torch.profiler,
    ``chip_smoke._sub_launch_ms``)."""
    subs = CS._sub_launch_ms(fn, calls)
    print(f"{name:8s} {label:34s} sub-launches, device ms per call "
          f"(total {sum(subs.values()):.4f}):", flush=True)
    for key, ms in sorted(subs.items(), key=lambda kv: -kv[1]):
        print(f"{name:8s}     {ms:9.4f} ms  {key}", flush=True)


@contextmanager
def forced(stage):
    """The forward recurrences on one launch, "stream" or "resident",
    whatever the plan picks (a tree with ``recur_plan`` only)."""
    plan = LC.recur_plan
    if stage == "stream":
        LC.recur_plan = lambda B, T, H: LC.RecurPlan("stream", *LC._tile(B, H))
    else:
        LC.recur_plan = lambda B, T, H: LC.RecurPlan(
            "resident", LC.block_rows(B), LC.RESIDENT_CLUSTER)
    try:
        yield
    finally:
        LC.recur_plan = plan


def stages():
    """The launches to time: the tree's own, then with ``--stages`` each
    forced launch of a tree that has ``recur_plan``."""
    yield ""
    if STAGES and hasattr(LC, "recur_plan"):
        for stage in ("stream", "resident"):
            with forced(stage):
                yield f" [{stage}]"


def plan_text(L, B, T, H):
    if not hasattr(LC, "recur_plan"):
        return ""
    return "  " + CS._recur_plan(L, B, T, H)[1]


def forced_rows(layers, xs, ls):
    """K4 at B = 8 on resident tiles of 1, 2 and 4 rows whatever the plan
    picks (16, 8 and 4 clusters: three, two and one wave of 7), the
    measurement behind ``stack_plan``'s rows."""
    plan = LC.stack_plan
    for rows in (1, 2, 4):
        def fixed(B, H, active, L=1, rows=rows):
            clusters = 2 * L * -(-B // rows)
            return LC.StackPlan("resident", rows, clusters,
                                -(-clusters // active))
        LC.stack_plan = fixed
        try:
            report(f"K4 6 layers B=8 {rows}-row tiles",
                   lambda: LC.blstm_stack(layers, xs, ls), 3)
        finally:
            LC.stack_plan = plan


def host_ns(fn, n=2000):
    """Mean host ns of one call of ``fn`` over n back-to-back calls."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n
    torch.cuda.synchronize()
    return dt


def k6_row():
    """K6 at (8, 49152) bf16: event and device ms, SHA-256, and the host
    ns of the wrapper's parts, whichever way the tree's wrapper does
    them."""
    from repro_torch import device as DV
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import build

    B, V = 8, 49152
    x = torch.randn(B, V, generator=gen).to(dev, torch.bfloat16)
    x[1, [7, V // 8 - 1, V // 8]] = 6.0
    report(f"K6 argmax B={B} V={V} bf16", lambda: DK.argmax_tokens(x), 200)
    fn = build.load("argmax").argmax_rows        # bound by the call above
    out = torch.empty(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [x.data_ptr(), out.data_ptr(), B, V, 0]
    if len(fn.argtypes) == 7:                    # the per-row slice count
        args.append(DK.argmax_slices(B, V, 2, DK._n_sm))
    args.append(stream)
    parts = {
        "argmax_tokens (whole)": lambda: DK.argmax_tokens(x),
        "require_kernel_device": lambda: DV.require_kernel_device(x),
        "build.load": lambda: build.load("argmax"),
        "current_stream": (lambda: torch.cuda.current_stream(dev)
                           .cuda_stream),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty": lambda: torch.empty(B, dtype=torch.int32,
                                           device=dev),
        "ctypes call": lambda: fn(*args),
        "torch.argmax": lambda: torch.argmax(x, dim=-1),
    }
    print(f"{name:8s} K6 host ns per call: " + ", ".join(
        f"{k} {host_ns(f):.0f}" for k, f in parts.items()), flush=True)


ws, x, lens = case(1, 1, 256, 1024, 512)                  # ASR admission
report("K1 B=1 T=256", lambda: LC.blstm_layer(*ws, x, lens), 10)
if hasattr(LC, "blstm_stack"):         # the fused stack beside the K1 loop
    for B in (1, 3, 8):
        layers = [case(1, B, 256, 260 if k == 0 else 1024, 512)[0]
                  for k in range(6)]
        _, xs, ls = case(1, B, 256, 260, 512)

        def loop(layers=layers, xs=xs, ls=ls):
            y = xs
            for w in layers:
                y = LC.blstm_layer(*w, y, ls)
            return y
        same = torch.equal(LC.blstm_stack(layers, xs, ls), loop())
        plan = (f"  plan {CS._stack_plan(B, 512)[1]}"
                if hasattr(LC, "stack_plan") else "")
        report(f"K4 6 layers B={B} T=256",
               lambda: LC.blstm_stack(layers, xs, ls), 3,
               f"  bit-identical to the K1 loop {same}{plan}")
        report(f"K1 loop 6 layers B={B}", loop, 3)
        if B == 8 and hasattr(LC, "stack_plan"):
            forced_rows(layers, xs, ls)


k6_row()


def stash_pair(tag, L, B, T, ws, x, lens, dy, iters, calls):
    """K1-stash and K2 on one input, timed with their sub-launches."""
    y, acts, cseq = LC.blstm_layer_train(*ws, x, lens)
    fwd = (lambda: LC.blstm_layer_train(*ws, x, lens))
    bwd = (lambda: LC.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4], x, y, acts,
                                      cseq, dy, lens))
    shape = f"L={L} B={B} T={T}{tag}"
    report(f"K1-stash {shape}", fwd, iters, plan_text(L, B, T, 512))
    sublaunches(f"K1-stash {shape}", fwd, calls)
    report(f"K2 {shape}", bwd, iters)
    sublaunches(f"K2 {shape}", bwd, calls)


# the paper's step: 16 learners x 16 rows, T = 21, var-len
ws, x, lens = case(CS.TRAIN_L, CS.TRAIN_B, CS.TRAIN_T, CS.TRAIN_D,
                   CS.TRAIN_H, var_len=True)
dy = torch.randn(CS.TRAIN_L, CS.TRAIN_B, CS.TRAIN_T, 2 * CS.TRAIN_H,
                 generator=gen).to(dev, torch.bfloat16)
for tag in stages():
    stash_pair(tag, CS.TRAIN_L, CS.TRAIN_B, CS.TRAIN_T, ws, x, lens, dy, 10,
               5)

# long utterances: 16 learners x 2 rows, T = 2000, K = 256, var-len
L, B, T, K = CS.LONG_L, CS.LONG_ROWS, CS.LONG_T, CS.LONG_K
ws, x, lens = CS._long_inputs(gen, L, B, T, 1024, 512, K)
dy = torch.randn(L, B, T, 1024, generator=gen).to(dev, torch.bfloat16)
if hasattr(LC, "blstm_layer_bwd_chunked"):
    for tag in stages():
        lens_c = LC.chunk_lengths(x, lens)
        fwd = (lambda: LC.blstm_layer_train_chunked(*ws, x, lens_c, chunk=K))
        y, hb, cb = fwd()
        bwd = (lambda y=y, hb=hb, cb=cb: LC.blstm_layer_bwd_chunked(
            *ws, x, y, hb, cb, dy, lens_c, chunk=K))
        report(f"K1-chunk L={L} B={B} T={T}{tag}", fwd, 3,
               plan_text(L, B, T, 512), device=False)
        sublaunches(f"K1-chunk L={L} B={B} T={T}{tag}", fwd, 2)
        report(f"K3 K={K} L={L} B={B} T={T}{tag}", bwd, 2,
               plan_text(L, B, K, 512), device=False)
        sublaunches(f"K3 K={K} L={L} B={B} T={T}{tag}", bwd, 1)
        del y, hb, cb
        stash_pair(tag, L, B, T, ws, x, lens_c, dy, 2, 1)
del ws, x, lens, dy


def train_ms(cfg, ds, learners, warmup, timed):
    """ms per ad_psgd step over ``timed`` steps after ``warmup``, and the
    run's peak device memory in GiB."""
    from repro_torch.launch.train import run, setup_training

    state, step, _ = setup_training(cfg, strategy_name="ad_psgd",
                                    n_learners=learners, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, rec = run(state, step, ds, steps=warmup + timed, device=dev)
    t = rec[warmup:]
    return (1e3 * sum(r[0] for r in t) / len(t),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def end_to_end():
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build
    from repro_torch.launch.evaluate import evaluate_params
    from repro_torch.models import lstm as LS
    from repro_torch.params import init_params

    build.build()                      # no first-use build inside a timing
    cfg = get_arch("swb2000-blstm")
    ds = make_dataset(cfg, seq_len=CS.LONG_T, batch=CS.LONG_BATCH, seed=0,
                      var_len=True)
    for label, c in (("chunked", dataclasses.replace(cfg, lstm_seq_chunk=-1)),
                     ("unchunked", cfg)):
        ms, peak = train_ms(c, ds, CS.LONG_L, 1, 2)
        print(f"{name:8s} train-long {label:10s} {ms:9.2f} ms/step  peak "
              f"{peak:.2f} GiB", flush=True)
    ds = make_dataset(cfg, seq_len=CS.TRAIN_T, batch=CS.TRAIN_L * CS.TRAIN_B,
                      seed=0, var_len=True)
    ms, peak = train_ms(cfg, ds, CS.TRAIN_L, 2, 10)
    print(f"{name:8s} train §V {ms:9.2f} ms/step  peak {peak:.2f} GiB",
          flush=True)
    CS._serve(cfg, requests=8, topc=0)              # warm-up
    _, pending, _, wave_s, dt, _ = CS._serve(cfg, requests=8, topc=0)
    frames = sum(len(f) for _, f in pending)
    print(f"{name:8s} serve 8 requests: mean wave "
          f"{1e3 * float(np.mean(wave_s)):.2f} ms, {dt:.3f} s, "
          f"{frames / dt:.1f} frames/s", flush=True)
    params = init_params(LS.param_specs(cfg), 0, dev)
    m = evaluate_params(cfg, params, batches=4, batch=8, seq_len=256,
                        var_len=True, beam=8, decode_chunk=8, device=dev)
    print(f"{name:8s} evaluate {m['frames_per_s']:.1f} frames/s", flush=True)


def crossing():
    """K1-stash's forward recurrence streamed and resident, device ms per
    call of the ``blstm_recur`` sub-launch, over a range of steps at 1-,
    2-, 4- and 8-row tiles (16 learners; 2 and 16 rows are the train-long
    and §V row counts)."""
    for B, steps in ((1, (4, 16, 64, 256)),
                     (CS.LONG_ROWS, (4, 8, 16, 32, 64, 128, 256)),
                     (4, (4, 16, 64, 256)),
                     (CS.TRAIN_B, (CS.TRAIN_T, 64, 256))):
        for T in steps:
            ws, x, lens = case(CS.TRAIN_L, B, T, CS.TRAIN_D, CS.TRAIN_H,
                               var_len=True)
            fwd = (lambda: LC.blstm_layer_train(*ws, x, lens))
            row = []
            for stage in ("stream", "resident"):
                with forced(stage):
                    ms = CS._sub_launch_ms(fwd, 5).get("blstm_recur",
                                                       float("nan"))
                    row.append(f"{stage} {ms:8.4f} ms  sha256 "
                               f"{digest(fwd())}")
            print(f"{name:8s} crossing L={CS.TRAIN_L} B={B} T={T:4d}  "
                  f"{'  '.join(row)}  plan {LC.recur_plan(B, T, 512).path}",
                  flush=True)


if not STAGES:
    end_to_end()
elif hasattr(LC, "recur_plan"):
    crossing()
