#!/usr/bin/env python3
"""Time the LM admissions (prefill and first token) of one source tree
on the card, at the full-width serving shapes that run K11.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and time them in turns (parent, change,
change, parent), all in one chip call so that every number comes from
the same card and host:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_prefill.py build/$r 3
    done

For each of ``chip_smoke.py``'s hybrid-serve (hymba-1.5b, 16 prompts of
64-2000 tokens, the first 1500), lm-serve (smollm-360m, 64-960, the
second 600) and moe-serve (granite-moe-3b-a800m, 64-960, the first 700)
request sets, random weights from seed 0, it builds the phase's
``Server`` (8 slots), admits one warm-up request, and then, the given
number of passes over (default 1), admits every request alone in turn
(the slots cleared whenever they are full), each admission timed on the
host's clock as ``serve_lm`` times it.  It prints each pass's mean
admission ms, the first forced-length request's, and the K11 launches of
the pass (32 per admission).  The trees' kernels are built into their
own ``build/torch_kernels/``.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (request sets and serve settings)

root = sys.argv[1]
passes = int(sys.argv[2]) if len(sys.argv) > 2 else 1
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402

name = root.rstrip("/").split("/")[-1]
CELLS = [  # arch, max_len, request set, index of the forced length
    ("hymba-1.5b", CS.HYB_CACHE, CS._hybrid_pending, 0),
    ("smollm-360m", CS.LM_S, CS._lm_pending, 1),
    ("granite-moe-3b-a800m", CS.LM_S, CS._moe_pending, 0),
]

for arch, max_len, pending_of, forced in CELLS:
    cfg = get_arch(arch)
    server = Server(cfg, slots=CS.LM_B, max_len=max_len, seed=CS.SEED)
    pending = pending_of(cfg)
    server.admit(-1, pending[0][1][:64], 4)      # warm-up, as the phases
    while server.active.any():
        server.step()
    server.reset()
    for run in range(passes):
        FA.launches = 0
        admit_s = []
        for i, (rid, prompt) in enumerate(pending):
            if i and i % CS.LM_B == 0:
                server.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.admit(rid, prompt, CS.HYB_MAX_NEW)   # ends in a host read
            admit_s.append(time.perf_counter() - t0)
        server.reset()
        print(f"{name:8s} {arch:22s} pass {run}  admission mean "
              f"{1e3 * np.mean(admit_s):8.3f} ms  the "
              f"{len(pending[forced][1])}-token request "
              f"{1e3 * admit_s[forced]:8.3f} ms  K11 launches "
              f"{FA.launches}", flush=True)
    del server
    torch.cuda.empty_cache()
