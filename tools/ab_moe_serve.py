#!/usr/bin/env python3
"""Time the full-width granite-moe-3b-a800m serve of one source tree on
the card.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and serve in turns (parent, change, change,
parent), all in one chip call so that every number comes from the same
card and host:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_moe_serve.py build/$r 5 [paged]
    done

Each of the given number of runs (default 1) serves ``chip_smoke.py``'s
moe-serve requests (16 prompts of 64-960 tokens, 8 slots, 24 new tokens
each, random weights from seed 0) after one warm-up request — with
``paged``, through the ``PagedServer`` of the moe-paged phase (its pool
of 16-token pages, K8 in place of K7) — and prints decoded tokens/s, the mean wave,
the mean admission (prefill and first token), the decode calls, the
launches of each kernel and a digest of every decoded token: the digests
of two trees agree when they decode the same tokens.  The trees' kernels
are built into their own ``build/torch_kernels/``.
"""
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (the moe-serve requests and counters)

root = sys.argv[1]
runs = int(sys.argv[2]) if len(sys.argv) > 2 else 1
paged = sys.argv[3:] == ["paged"]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import numpy as np  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.serve import PagedServer, Server  # noqa: E402

name = root.rstrip("/").split("/")[-1] + (" paged" if paged else "")
cfg = get_arch("granite-moe-3b-a800m")
if paged:
    server = PagedServer(cfg, pool_pages=CS.LM_POOL, page_size=CS.LM_P,
                         max_len=CS.LM_S, seed=CS.SEED)
else:
    server = Server(cfg, slots=CS.LM_B, max_len=CS.LM_S, seed=CS.SEED)
attn = "paged_decode_attention" if paged else "decode_attention"
pending = CS._moe_pending(cfg)
server.admit(-1, pending[0][1][:64], 4)          # warm-up, as moe-serve
while server.active.any():
    server.step()
server.reset()
for run in range(runs):
    finished, admit_s, wave_s, occ, dt, counts = CS._moe_run(
        server, pending, CS.MOE_MAX_NEW)
    n_tok = sum(len(t) for t in finished.values())
    calls = counts[attn] // cfg.n_layers
    digest = hashlib.sha256(str(sorted(finished.items())).encode())
    print(f"{name:8s} run {run}  {n_tok / dt:8.3f} tokens/s  wave "
          f"{1e3 * np.mean(wave_s):8.3f} ms  admission "
          f"{1e3 * np.mean(admit_s):7.3f} ms  {len(wave_s)} waves, {calls} "
          f"decode calls ({1e3 * sum(wave_s) / calls:7.3f} ms each)  tokens "
          f"{digest.hexdigest()[:16]}  launches {counts}", flush=True)
    server.reset()
