#!/usr/bin/env python3
"""Time the BLSTM recurrence kernels of one source tree on the card.

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
graph).  Weights and inputs are drawn from seed 0.  The trees' kernels
are built into their own ``build/torch_kernels/``; a tree with the fused
stack (K4) also times it, and the K1 loop it is bit-identical to, at
B = 1, 3 and 8 (one, four and eight rows per recurrence tile).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (timing and input helpers)

root = sys.argv[1]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import lstm_cell as LC  # noqa: E402

dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
name = root.rstrip("/").split("/")[-1]


def case(L, B, T, D, H):
    return CS._stacked_inputs(L, B, T, D, H, gen, False)


def device_ms(fn, iters):
    return CS._device_ms(fn, iters=iters, reps=2) or 0.0


def report(label, fn, iters, extra=""):
    print(f"{name:8s} {label:26s} event {CS._time_ms(fn, iters):9.3f} ms  "
          f"device {device_ms(fn, iters):9.3f} ms{extra}", flush=True)


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
        report(f"K4 6 layers B={B} T=256",
               lambda: LC.blstm_stack(layers, xs, ls), 3,
               f"  bit-identical to the K1 loop {same}")
        report(f"K1 loop 6 layers B={B}", loop, 3)
ws, x, lens = case(16, 16, 21, 1024, 512)                 # the paper's step
report("K1-stash L=16 B=16 T=21",
       lambda: LC.blstm_layer_train(*ws, x, lens), 10)
ws, x, lens = case(16, 2, 500, 1024, 512)                 # long utterances
report("K1-stash L=16 B=2 T=500",
       lambda: LC.blstm_layer_train(*ws, x, lens), 3)
y, acts, cseq = LC.blstm_layer_train(*ws, x, lens)
dy = torch.randn(16, 2, 500, 1024, generator=gen).to(dev, torch.bfloat16)
report("K2 L=16 B=2 T=500", lambda: LC.blstm_layer_bwd(
    ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq, dy, lens), 3)
if hasattr(LC, "blstm_layer_bwd_chunked"):
    for K in (500, 100):        # one chunk (K3's recurrences vs K2's), five
        y, hb, cb = LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K)
        fn = (lambda y=y, hb=hb, cb=cb, K=K: LC.blstm_layer_bwd_chunked(
            *ws, x, y, hb, cb, dy, lens, chunk=K))
        report(f"K3 K={K} L=16 B=2 T=500", fn, 3)
    report("K1-chunk L=16 B=2 T=500", lambda: LC.blstm_layer_train_chunked(
        *ws, x, lens, chunk=256), 3)
