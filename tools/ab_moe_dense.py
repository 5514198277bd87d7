#!/usr/bin/env python3
"""Time the fused dense-MoE kernel (K10) of one source tree on the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from the
same card:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_moe_dense.py build/$r
    done

At granite-moe-3b-a800m's FFN (d 1536, 40 experts of d_ff 512, top-8 of
a softmax over random router logits, weights at the model's init scales,
all drawn from seed 0) and T = 1, 8 and 700 tokens it prints the time of
one wrapper call from CUDA events over back-to-back calls (eager), its
device time with the host's dispatch taken out (``chip_smoke._device_ms``:
calls replayed from one CUDA graph), the device time of each kernel the
call launches (torch.profiler over 20 calls), the bound
(``chip_smoke._moe_bytes_ops``: the weights of the experts some token
weights, once, against the products of the non-zero weights), the
row-normalised error against ``moe_dense_plain`` and a digest of the
output (equal between turns of one tree).  With ``--plan`` a tree that
has a launch plan (``moe_dense.launch_plan``) prints it too.  Each
tree's kernels are built into its own ``build/torch_kernels/``.
"""
import hashlib
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (inputs, timing and bound helpers)

root = sys.argv[1]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import torch  # noqa: E402

from repro_torch.kernels import moe_dense as MD  # noqa: E402
from repro_torch.kernels.ref import moe_dense_plain  # noqa: E402

name = root.rstrip("/").split("/")[-1]
TS = (1, 8, 700)


def kernels_us(call, calls=20):
    """Device µs per call of each kernel ``call`` launches."""
    call()
    got = CS._profile_window(lambda: [call() for _ in range(calls)],
                             "ab-moe-dense")
    if got is None:
        return {}
    out = {}
    for us, _, key in got[3]:
        found = re.search(r"(\w+_kernel)", key)
        label = found.group(1) if found else key[:32]
        out[label] = round(out.get(label, 0.0) + us / calls, 2)
    return out


gen = torch.Generator().manual_seed(CS.SEED)
wi, wg, wo = CS._moe_weights(gen, CS.MOE_D, CS.MOE_E, CS.MOE_F)
for T in TS:
    x = torch.randn(T, CS.MOE_D, generator=gen).to("cuda", torch.bfloat16)
    w = CS._router_weights(gen, T, CS.MOE_E, CS.MOE_K, "topk")

    def call(x=x, w=w):
        return MD.moe_dense(x, w, wi, wg, wo)
    y = call()
    err = CS._row_err(y, moe_dense_plain(x, w, wi, wg, wo))[1]
    nbytes, ops, used = CS._moe_bytes_ops(w, CS.MOE_D, CS.MOE_F)
    bound, by = CS._bound(nbytes, ops, CS.PEAK_BF16_FLOPS)
    eager = CS._time_ms(call, 50)
    device = CS._device_ms(call, iters=20, reps=5) or 0.0
    digest = hashlib.sha256(y.cpu().view(torch.int16).numpy().tobytes())
    print(f"{name:8s} T={T:4d}  event {eager:8.4f} ms  device {device:8.4f} "
          f"ms  bound {bound:.5f} ms ({by}, {used} experts)  row err "
          f"{err:.3g}  y {digest.hexdigest()[:16]}  kernels (us) "
          f"{kernels_us(call)}", flush=True)
    if "--plan" in sys.argv and hasattr(MD, "launch_plan"):
        print(f"{name:8s} T={T:4d}  plan "
              f"{MD.launch_plan(T, CS.MOE_D, CS.MOE_E, CS.MOE_F)}",
              flush=True)
