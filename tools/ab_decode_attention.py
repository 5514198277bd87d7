#!/usr/bin/env python3
"""Time the decode-attention kernels K7 (dense) and K8 (paged) of one
source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from
the same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_decode_attention.py build/$r
    done

For each shape it prints the time of one wrapper call from CUDA events
over back-to-back calls (eager) and its device time with the host's
dispatch taken out (``chip_smoke._device_ms``: calls replayed from one
CUDA graph), and checks the output against the plain version (each
(row, head)'s error over its largest value, ``chip_smoke._row_err``) and
against a float64 evaluation of the same function from the same bf16
inputs (the kernel's and the plain version's distance beside each
other).  Inputs are drawn from seed 0, the same in every tree; each
tree's kernels are built into its own ``build/torch_kernels/``.  Every
call is the delta variant (the servers' decode), at pos 511 of a
1024-row cache or pool of 16-row pages unless said:

* smollm-360m, 15 heads over 5, E = 64, at 8 slots and at one request;
* hymba-1.5b, 25 heads over 5, pos 1600 of a 2048-row cache under its
  1024-row window, 8 slots and one request (K7 only: the paged server
  refuses the family);
* granite-moe-3b-a800m, 24 heads over 8, 8 slots and one request;
* smollm's shapes at pos 0, where the delta variant reads no cache row:
  the launch, the new column and the merge alone (K7 only).

A tree whose wrapper has a launch plan (``decode_attention.decode_plan``)
also prints each shape's plan and times it at the plan's split count
halved and doubled (at most 16, at most one split per tile).

Last, where a wrapper call's eager time goes at smollm's one request:
the mean host ns (``time.perf_counter_ns`` over back-to-back calls) of
the whole K7 and K8 calls and of each part of K7's wrapper, as the
tree's wrapper does them — the device check, the shape checks, the plan
lookups, the output's allocation, the stream handle and the bare ctypes
call that launches the kernel.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (timing helpers)

root = sys.argv[1]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import decode_attention as DA  # noqa: E402

name = root.rstrip("/").split("/")[-1]
P, S_LM, S_HYB = 16, 1024, 2048
SHAPES = [  # tag, B, KV, M, S, pos, window, paged too
    ("smollm B=8", 8, 5, 3, S_LM, 511, None, True),
    ("smollm B=1", 1, 5, 3, S_LM, 511, None, True),
    ("hymba B=8", 8, 5, 5, S_HYB, 1600, 1024, False),
    ("hymba B=1", 1, 5, 5, S_HYB, 1600, 1024, False),
    ("granite B=8", 8, 8, 3, S_LM, 511, None, True),
    ("granite B=1", 1, 8, 3, S_LM, 511, None, True),
    ("no old row B=8", 8, 5, 3, S_LM, 0, None, False),
    ("no old row B=1", 1, 5, 3, S_LM, 0, None, False),
]


def attn_f64(q, kc, vc, pos, window, kn, vn):
    """The delta variant's function in float64 from the bf16 inputs."""
    B, _, H, E = q.shape
    KV = kc.shape[2]
    lo = 0 if window is None else max(0, pos - window + 1)
    qg = q.reshape(B, KV, H // KV, E).double()
    k = torch.cat([kc[:, lo:pos], kn], 1).double()
    v = torch.cat([vc[:, lo:pos], vn], 1).double()
    s = torch.einsum("bgme,btge->bgmt", qg, k) / E ** 0.5
    o = torch.einsum("bgmt,btge->bgme", torch.softmax(s, -1), v)
    return o.reshape(B, 1, H, E)


def report(label, fn, want, exact):
    got = fn()
    err = CS._row_err(got, want)[1]
    f64 = CS._row_err(got, exact)[1]
    f64_plain = CS._row_err(want, exact)[1]
    print(f"{name:8s} {label:34s} event {CS._time_ms(fn, 200):8.4f} ms  "
          f"device {CS._device_ms(fn, iters=50, reps=5) or 0.0:8.4f} ms  "
          f"row err {err:.3g}  f64 {f64:.3g} (plain {f64_plain:.3g})",
          flush=True)


def with_plan(label, fn, want, exact, block_s):
    """The plan the wrapper takes, then the shape at its split count
    halved and doubled."""
    real, seen = DA.decode_plan, []
    DA.decode_plan = lambda *a: seen.append(real(*a)) or seen[-1]
    try:
        fn()
    finally:
        DA.decode_plan = real
    plan = seen[-1]
    print(f"{name:8s}     plan {plan}", flush=True)
    for n in sorted({plan.n_split // 2,
                     min(DA.MAX_SPLIT, plan.tiles, 2 * plan.n_split)}):
        if n in (0, plan.n_split):
            continue
        forced = plan._replace(n_split=n, rows=-(-plan.tiles // n) * block_s)
        DA.decode_plan = lambda *a, forced=forced: forced
        try:
            report(f"{label} n_split={n}", fn, want, exact)
        finally:
            DA.decode_plan = real


gen = torch.Generator().manual_seed(0)
for tag, B, KV, M, S, pos, window, paged in SHAPES:
    q, kc, vc, kn, vn = CS._attn_inputs(gen, B, S, KV, M, 64)
    kw = dict(window=window, k_new=kn, v_new=vn)
    exact = attn_f64(q, kc, vc, pos, window, kn, vn)
    want = DA.decode_attention_ref(q, kc, vc, pos, **kw)

    def dense(q=q, kc=kc, vc=vc, pos=pos, kw=kw):
        return DA.decode_attention(q, kc, vc, pos, **kw)
    report(f"K7 {tag}", dense, want, exact)
    if hasattr(DA, "decode_plan"):
        with_plan(f"K7 {tag}", dense, want, exact, DA.DEFAULT_BLOCK_S)
    if not paged:
        continue
    # the same rows behind a shuffled table over a pool of B * S / P pages
    n_pages = B * S // P
    perm = torch.randperm(n_pages, generator=gen).to("cuda")
    tbl = perm.to(torch.int32).reshape(B, S // P)
    kp = torch.empty(n_pages, P, KV, 64, device="cuda", dtype=torch.bfloat16)
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(n_pages, P, KV, 64)
    vp[perm] = vc.reshape(n_pages, P, KV, 64)

    def pagedf(q=q, kp=kp, vp=vp, tbl=tbl, pos=pos, kw=kw):
        return DA.paged_decode_attention(q, kp, vp, tbl, pos, **kw)
    report(f"K8 {tag}", pagedf, want, exact)
    if hasattr(DA, "decode_plan"):
        with_plan(f"K8 {tag}", pagedf, want, exact, P)


def host_ns(fn, n=2000):
    """Mean host ns of one call of ``fn`` over n back-to-back calls."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n
    torch.cuda.synchronize()
    return dt


def host_parts():
    """K7's and K8's wrappers at smollm's one request (delta, pos 511),
    whole and, for K7, by part."""
    from repro_torch import device as DV
    from repro_torch.kernels import build

    B, KV, M, E, S, pos = 1, 5, 3, 64, S_LM, 511
    q, kc, vc, kn, vn = CS._attn_inputs(gen, B, S, KV, M, E)
    kp, vp = kc.reshape(S // P, P, KV, E), vc.reshape(S // P, P, KV, E)
    tbl = torch.arange(S // P, device="cuda", dtype=torch.int32)[None]
    out = torch.empty_like(q)
    DA.decode_attention(q, kc, vc, pos, k_new=kn, v_new=vn)   # binds the lib
    fn = build.load("decode_attention").decode_attention
    ptrs = [t.data_ptr() for t in (q, kc, vc, kn, vn, out)]
    stream = torch._C._cuda_getCurrentRawStream(0)
    if hasattr(DA, "decode_plan"):
        plan = DA.decode_plan(B, KV, S, E, pos, None, True, 16,
                              DA.fit_splits(True, M, E, B * KV))
        args = ptrs + [B, S, KV, M, E, 16, plan.lo, plan.hi, plan.n_split,
                       DA._scale(E), stream]
        cache = (B, S, KV, E)

        def checks():
            DA._group(q, KV, 16)
            DA._fits(kc, cache)
            DA._fits(vc, cache)
            DA._new_column(q, kn, vn, B, KV, E)

        plan_parts = {
            "fit_splits": lambda: DA.fit_splits(True, M, E, B * KV),
            "decode_plan": lambda: DA.decode_plan(B, KV, S, E, pos, None,
                                                  True, 16, 4)}
    else:
        bs = DA.auto_block_s(S)
        args = ptrs + [B, S, KV, M, E, bs, pos, DA.NO_WINDOW,
                       DA._scale(E), stream]

        def checks():
            DA._check_common(q, kc, kn, vn, bs)
            for t in (kc, vc):
                DA._check("cache", t, (B, S, KV, E), torch.bfloat16,
                          q.device)
            DA._pos_win(pos, None)

        plan_parts = {"_lib": DA._lib}
    parts = {
        "K7 (whole)": lambda: DA.decode_attention(q, kc, vc, pos, k_new=kn,
                                                  v_new=vn),
        "K8 (whole)": lambda: DA.paged_decode_attention(
            q, kp, vp, tbl, pos, k_new=kn, v_new=vn),
        "require_kernel_device": lambda: DV.require_kernel_device(q),
        "checks": checks,
        **plan_parts,
        "torch.empty_like": lambda: torch.empty_like(q),
        "current_stream": (lambda: torch.cuda.current_stream(q.device)
                           .cuda_stream),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes call": lambda: fn(*args),
    }
    print(f"{name:8s} host ns per call (smollm B=1): " + ", ".join(
        f"{k} {host_ns(f):.0f}" for k, f in parts.items()), flush=True)


host_parts()
