#!/usr/bin/env python3
"""Time the chunked SSD scan (K9) of one source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from the
same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_ssd.py build/$r
    done

At the served prefill shapes — mamba2-370m (B = 1, S = 700, 32 heads of
P = 64, N = 128, one B/C group, Q = 256: a ragged last chunk of 188) and
hymba-1.5b (S = 1500, 50 heads, N = 16) — with bf16 inputs drawn from
seed 0 (``chip_smoke._ssd_inputs``, the same in every tree) it prints the
time of one wrapper call from CUDA events over back-to-back calls
(eager), its device time with the host's dispatch taken out
(``chip_smoke._device_ms``: calls replayed from one CUDA graph), the
device µs of each launch the call makes (torch.profiler over 20 calls),
the bound (``chip_smoke._ssd_bytes_ops``), the normalised errors of y and
the state against ``ref.ssd_plain``, a digest of y and of the state
(equal between turns of one tree), and the wrapper's host µs per call
(back-to-back calls on the host clock, the device left to catch up
after).  A tree with ``ssd_scan.ssd_plan`` prints the plan too.  Each
tree's kernels are built into its own ``build/torch_kernels/``.

``--short`` times the admissions of short prompts instead: mamba2 at S =
64, 128, 256 and 512 and hymba at S = 64, 128 and 256 (one or two
chunks, so 32 to 100 work items on the card's SMs).  ``--p-tiles=32,64``
also times each shape with the plan's channels an output CTA owns
(``p_tile``) forced to each of those values, for a tree whose plan picks
them.
"""
import hashlib
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (inputs, timing and bound helpers)

root = sys.argv[1]
SHORT = "--short" in sys.argv[2:]
TILES = [int(t) for a in sys.argv[2:] if a.startswith("--p-tiles=")
         for t in a.split("=", 1)[1].split(",")]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import ssd_plain  # noqa: E402

name = root.rstrip("/").split("/")[-1]
SHAPES = [("mamba2 S=700", 1, 700, 32, 64, 1, 128, 256),
          ("hymba S=1500", 1, 1500, 50, 64, 1, 16, 256)]
if SHORT:
    SHAPES = ([(f"mamba2 S={S}", 1, S, 32, 64, 1, 128, 256)
               for S in (64, 128, 256, 512)]
              + [(f"hymba S={S}", 1, S, 50, 64, 1, 16, 256)
                 for S in (64, 128, 256)])
PLAN = getattr(SSD, "ssd_plan", None)


def launches_us(call, calls=20):
    """Device µs per call of each kernel ``call`` launches."""
    call()
    got = CS._profile_window(lambda: [call() for _ in range(calls)],
                             "ab-ssd")
    if got is None:
        return {}
    out = {}
    for us, _, key in got[3]:
        found = re.search(r"(ssd_\w+)", key)
        label = found.group(1) if found else key[:32]
        out[label] = round(out.get(label, 0.0) + us / calls, 2)
    return out


def host_us(call, calls=200):
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        call()
    t = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return t


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def forced(p_tile):
    """``ssd_plan`` with the output CTAs' channels set to ``p_tile``."""
    def plan(*args):
        return dict(PLAN(*args), p_tile=p_tile)
    return plan


n_sm = torch.cuda.get_device_properties(0).multi_processor_count
for tag, B, S, H, P, G, N, Q in SHAPES:
    gen = torch.Generator().manual_seed(CS.SEED)
    args = CS._ssd_inputs(gen, B, S, H, P, G, N)
    want_y, want_h = ssd_plain(*args, chunk=Q)
    nbytes, ops = CS._ssd_bytes_ops(B, S, H, P, G, N, Q)
    bound, by = CS._bound(nbytes, ops)
    variants = [("", PLAN)]
    if PLAN is not None and "p_tile" in PLAN(1, 1, 1, 1, 1, 1, 1, n_sm):
        variants += [(f" p_tile {t}", forced(t)) for t in TILES]
    for label, plan in variants:
        if plan is not None:
            SSD.ssd_plan = plan

        def call(args=args, Q=Q):
            return SSD.ssd(*args, chunk=Q)
        y, h = call()
        ey, eh = CS._norm_err(y, want_y)[1], CS._norm_err(h, want_h)[1]
        eager = CS._time_ms(call, 50)
        device = CS._device_ms(call, iters=20, reps=5) or 0.0
        print(f"{name:8s} {tag}{label}  event {eager:8.4f} ms  device "
              f"{device:8.4f} ms  bound {bound:.5f} ms ({by})  err y "
              f"{ey:.3g} state {eh:.3g}  y {digest(y)} state {digest(h)}  "
              f"host {host_us(call):.1f} us  launches (us) "
              f"{launches_us(call)}", flush=True)
    if PLAN is not None:
        SSD.ssd_plan = PLAN
        print(f"{name:8s} {tag}  plan "
              f"{PLAN(B, S, H, P, G, N, min(Q, S), n_sm)}", flush=True)
