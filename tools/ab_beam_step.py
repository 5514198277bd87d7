#!/usr/bin/env python3
"""Time the CTC beam frame step (K5) of one source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from the
same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_beam_step.py build/$r
    done

At serve's B = 4 and evaluate's B = 8 rows (K = 8, V = 32000, a beam
state six frames into a decode of peaked posteriors, all drawn from seed
0 as ``chip_smoke._k5_states`` draws them), unpruned and top-C (C = 16),
it prints the time of one wrapper call from CUDA events over
back-to-back calls (eager), its device time with the host's dispatch
taken out (``chip_smoke._device_ms``), the bound
(``chip_smoke._k5_bound`` where the tree has it), whether sel and the
scores equal the plain frame step's, a digest of (sel, new_pb, new_pnb)
(equal between trees: K5 keeps them bit for bit) and the wrapper's host
µs per call (back-to-back calls on the host clock).  A tree with
``decode.kernel.beam_slices`` prints the CTAs a row too.  Each tree's
kernels are built into its own ``build/torch_kernels/``.
"""
import hashlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (inputs and timing helpers)

root = sys.argv[1]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.decode import beam as DB  # noqa: E402
from repro_torch.decode import kernel as DK  # noqa: E402

name = root.rstrip("/").split("/")[-1]
K, V = 8, 32000


def host_us(call, calls=200):
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        call()
    t = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return t


n_sm = torch.cuda.get_device_properties(0).multi_processor_count
for B in (4, 8):
    gen = torch.Generator().manual_seed(CS.SEED)
    logp = torch.log_softmax(torch.randn(B, V, generator=gen).to("cuda")
                             * 3.0, dim=-1).contiguous()
    st = CS._k5_states(B, K, V, gen)[0][1]
    args = (logp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
    for topc in (0, 16):
        kw = dict(blank=0, max_len=64, semiring="max", topc=topc)

        def call(args=args, kw=kw):
            return DK.beam_frame_step(*args, **kw)
        got = call()
        want = (DB.frame_step_scores_topc(*args, **kw) if topc else
                DB.frame_step_scores(*args, **{k: v for k, v in kw.items()
                                               if k != "topc"}))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().numpy().tobytes())
        eager = CS._time_ms(call, 50)
        device = CS._device_ms(call, iters=20, reps=5) or 0.0
        bound = CS._k5_bound(B, K, V, topc)[0] if hasattr(
            CS, "_k5_bound") else float("nan")
        plan = (f"  {DK.beam_slices(B, V, n_sm)} CTAs a row"
                if hasattr(DK, "beam_slices") else "")
        print(f"{name:8s} B={B} C={topc:2d}  event {eager:8.4f} ms  device "
              f"{device:8.4f} ms  bound {bound:.5f} ms  equal {equal}  "
              f"digest {h.hexdigest()[:16]}  host {host_us(call):.1f} us"
              f"{plan}", flush=True)
