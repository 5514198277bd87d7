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
graph).  Weights and inputs are drawn from seed 0.  The trees' kernels
are built into their own ``build/torch_kernels/``.  Cases:

* K1 inference at the ASR admission's shape (B = 1, T = 256);
* the fused stack K4 and the K1 loop it is bit-identical to, 6 layers at
  B = 1, 3 and 8 (a tree without K4 skips them);
* K1-stash and K2 at the paper's training shape (16 learners x 16 rows,
  T = 21, D = 1024, H = 512, var-len), each with its sub-launches: the
  device time per call of every kernel it launches from torch.profiler
  (``lstm_xproj`` and ``blstm_recur``; ``lstm_bwd_recur``, ``lstm_bwd_dx``
  and ``lstm_bwd_dw``, the layout copies as torch ops);
* K1-chunk and K3 at the train-long layer shape (16 learners x 2 rows,
  T = 2000, K = 256, var-len), with their sub-launches.

A tree whose ``lstm_cell`` has ``CLUSTER_SIZES`` times its recurrences at
each of those cluster sizes too (``lstm_cell.cluster_size``).
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


def case(L, B, T, D, H, var_len=False):
    return CS._stacked_inputs(L, B, T, D, H, gen, var_len)


def device_ms(fn, iters):
    return CS._device_ms(fn, iters=iters, reps=2) or 0.0


def report(label, fn, iters, extra=""):
    print(f"{name:8s} {label:30s} event {CS._time_ms(fn, iters):9.3f} ms  "
          f"device {device_ms(fn, iters):9.3f} ms{extra}", flush=True)


def sublaunches(label, fn, calls):
    """Device ms per call of each sub-launch of ``fn`` (torch.profiler,
    ``chip_smoke._sub_launch_ms``)."""
    subs = CS._sub_launch_ms(fn, calls)
    print(f"{name:8s} {label:30s} sub-launches, device ms per call "
          f"(total {sum(subs.values()):.4f}):", flush=True)
    for key, ms in sorted(subs.items(), key=lambda kv: -kv[1]):
        print(f"{name:8s}     {ms:9.4f} ms  {key}", flush=True)


def clusters():
    """The recurrences' cluster sizes to time: a tree with
    ``lstm_cell.CLUSTER_SIZES`` runs both recurrences at each in turn."""
    sizes = getattr(LC, "CLUSTER_SIZES", None)
    if not sizes:
        yield ""
        return
    default = LC.cluster_size
    for c in sizes:
        LC.cluster_size = c
        yield f" C={c}"
    LC.cluster_size = default


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

# the paper's step: 16 learners x 16 rows, T = 21, var-len
ws, x, lens = case(CS.TRAIN_L, CS.TRAIN_B, CS.TRAIN_T, CS.TRAIN_D,
                   CS.TRAIN_H, var_len=True)
dy = torch.randn(CS.TRAIN_L, CS.TRAIN_B, CS.TRAIN_T, 2 * CS.TRAIN_H,
                 generator=gen).to(dev, torch.bfloat16)
for tag in clusters():
    y, acts, cseq = LC.blstm_layer_train(*ws, x, lens)
    fwd = (lambda: LC.blstm_layer_train(*ws, x, lens))
    bwd = (lambda y=y, acts=acts, cseq=cseq: LC.blstm_layer_bwd(
        ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq, dy, lens))
    report(f"K1-stash L=16 B=16 T=21{tag}", fwd, 10)
    sublaunches(f"K1-stash L=16 B=16 T=21{tag}", fwd, 5)
    report(f"K2 L=16 B=16 T=21{tag}", bwd, 10)
    sublaunches(f"K2 L=16 B=16 T=21{tag}", bwd, 5)

# long utterances: 16 learners x 2 rows, T = 2000, K = 256, var-len
ws, x, lens = case(16, 2, 2000, 1024, 512, var_len=True)
dy = torch.randn(16, 2, 2000, 1024, generator=gen).to(dev, torch.bfloat16)
if hasattr(LC, "blstm_layer_bwd_chunked"):
    for tag in clusters():
        lens_c = LC.chunk_lengths(x, lens)
        fwd = (lambda: LC.blstm_layer_train_chunked(*ws, x, lens_c,
                                                    chunk=256))
        y, hb, cb = fwd()
        bwd = (lambda y=y, hb=hb, cb=cb: LC.blstm_layer_bwd_chunked(
            *ws, x, y, hb, cb, dy, lens_c, chunk=256))
        report(f"K1-chunk L=16 B=2 T=2000{tag}", fwd, 3)
        sublaunches(f"K1-chunk L=16 B=2 T=2000{tag}", fwd, 2)
        report(f"K3 K=256 L=16 B=2 T=2000{tag}", bwd, 2)
        sublaunches(f"K3 K=256 L=16 B=2 T=2000{tag}", bwd, 1)
