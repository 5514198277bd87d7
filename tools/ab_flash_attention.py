#!/usr/bin/env python3
"""Time the flash-attention kernel (K11) of one source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from
the same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_flash_attention.py build/$r
    done

For each shape it prints the time of one wrapper call from CUDA events
over back-to-back calls (eager) and its device time with the host's
dispatch taken out (``chip_smoke._device_ms``: calls replayed from one
CUDA graph), and checks the output against ``flash_attention_plain``
(row-normalised, as ``chip_smoke._row_err``).  Inputs are drawn from
seed 0; each tree's kernels are built into its own
``build/torch_kernels/``.  Shapes (B = 1, E = 64, causal prefill unless
said):

* hymba-1.5b, S = 1500, 25 heads over 5, window 1024 and global;
* smollm-360m, S = 600, 15 heads over 5;
* granite-moe-3b-a800m, S = 700, 24 heads over 8 (K11 in moe-serve and
  moe-paged);
* 8 heads over one KV head at S = 1500 (MQA), a grid that 128-row
  items leave short (94 of them): the check of the plan's 64-row items,
  whose key walk two warpgroups share;
* stablelm-12b, S = 1000, 32 heads over 8, E = 160 (skipped, said, for a
  tree whose kernel has no E = 160);
* whisper-large-v3's encoder (S = 1500, 20 heads, MHA, non-causal) and
  cross-attention (4 queries over 1500 keys, non-causal).

A tree whose wrapper has a launch plan (``flash_attention.plan``) also
prints the plan and times each shape at every other item size of
``ITEM_ROWS`` (the plan's rows replaced, nothing else).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (timing helpers)

root = sys.argv[1]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402

name = root.rstrip("/").split("/")[-1]
SHAPES = [  # tag, Sq, Sk, H, KV, E, causal, window
    ("hymba windowed", 1500, 1500, 25, 5, 64, True, 1024),
    ("hymba global", 1500, 1500, 25, 5, 64, True, CS.GLOBAL),
    ("smollm S=600", 600, 600, 15, 5, 64, True, CS.GLOBAL),
    ("granite S=700", 700, 700, 24, 8, 64, True, CS.GLOBAL),
    ("MQA S=1500", 1500, 1500, 8, 1, 64, True, CS.GLOBAL),
    ("stablelm E=160", 1000, 1000, 32, 8, 160, True, CS.GLOBAL),
    ("whisper encoder", 1500, 1500, 20, 20, 64, False, 0),
    ("whisper cross", 4, 1500, 20, 20, 64, False, 0),
]


def report(label, fn, q, k, v, kw):
    err = CS._row_err(fn(), flash_attention_plain(q, k, v, **kw))[1]
    print(f"{name:8s} {label:40s} event {CS._time_ms(fn, 50):8.4f} ms  "
          f"device {CS._device_ms(fn, iters=50, reps=5) or 0.0:8.4f} ms  "
          f"row err {err:.3g}", flush=True)


def item_sizes(E):
    """The item sizes the tree's kernel has at head_dim E."""
    if hasattr(FA, "item_rows"):
        return FA.item_rows(E)
    return [r for r in getattr(FA, "ITEM_ROWS", ())
            if not (r == 192 and E > 64)]


gen = torch.Generator().manual_seed(0)
for tag, Sq, Sk, H, KV, E, causal, window in SHAPES:
    q, k, v = (torch.randn(1, S, h, E, generator=gen).to("cuda",
                                                         torch.bfloat16)
               for S, h in ((Sq, H), (Sk, KV), (Sk, KV)))
    if E not in FA.HEAD_DIMS:
        print(f"{name:8s} {tag:40s} not timed: E = {E} is not one of the "
              f"tree's head dims {FA.HEAD_DIMS}", flush=True)
        continue
    kw = dict(causal=causal, window=window, q_offset=0)

    def call(q=q, k=k, v=v, kw=kw):
        return FA.flash_attention(q, k, v, **kw)
    report(tag, call, q, k, v, kw)
    if not hasattr(FA, "plan"):
        continue
    real_plan, seen = FA.plan, []
    FA.plan = lambda *a: seen.append(real_plan(*a)) or seen[-1]
    try:
        call()                            # the plan the wrapper takes
    finally:
        FA.plan = real_plan
    rule = seen[-1]
    print(f"{name:8s}     plan {rule}", flush=True)
    for rows in item_sizes(E):            # the other item sizes
        if rows == rule.rows:
            continue
        tiles = -(-Sq * (H // KV) // rows)
        forced = rule._replace(rows=rows, tiles=tiles, items=tiles * KV)
        FA.plan = lambda *a, forced=forced: forced
        try:
            report(f"{tag} rows={rows}", call, q, k, v, kw)
        finally:
            FA.plan = real_plan
