#!/usr/bin/env python3
"""Time the serving phases that run K9 (prefill) and K5 (beam decode) of
one source tree on the card, with a digest of what they decode.

Compares two commits of the PyTorch/CUDA port on one card: unpack each
into a git-ignored directory and run them in turns (parent, change,
change, parent), all in one chip call so that every number comes from the
same card and host:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for r in parent change change parent; do
        python3 tools/ab_serve_phases.py build/$r 2
    done

With ``chip_smoke.py``'s settings, random weights from seed 0 and the
given number of passes (default 1) after a warm-up, it prints for each:

* ssm-serve (full-width mamba2-370m, 16 prompts of 64-960 tokens, the
  first 700, 8 slots, 32 new tokens) and hybrid-serve (hymba-1.5b, 16
  prompts of 64-2000 tokens, the first 1500, 24 new tokens): the mean
  admission ms (prefill and first token), the mean wave ms, decoded
  tokens/s, K9's launches and a digest of every request's tokens;
* serve (swb2000-blstm, 8 utterances, 4 slots, beam 8, chunks of 8
  frames) and its top-C run (C = 16, 4 utterances): the mean wave ms,
  frames/s, K5's launches and a digest of the hypotheses;
* evaluate (4 batches of 8 x 256 frames, var-len, beam 8, decode chunks
  of 8, weights from seed 0): frames/s, the forward and decode ms and a
  digest of the beam hypotheses (``decode.finalize``'s tokens and
  lengths).

``--lm-only`` (after the passes) runs ssm-serve and hybrid-serve alone.
Each tree's kernels are built into its own ``build/torch_kernels/``.
"""
import hashlib
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (request sets and serve settings)

root = sys.argv[1]
passes = int(sys.argv[2]) if len(sys.argv) > 2 else 1
LM_ONLY = "--lm-only" in sys.argv[3:]
sys.path.insert(0, root + "/src")         # ahead of chip_smoke's own tree

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch import decode as DC  # noqa: E402
from repro_torch.decode import kernel as DK  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch.evaluate import evaluate_params  # noqa: E402
from repro_torch.launch.serve import Server, serve_lm  # noqa: E402
from repro_torch.models import lstm as LS  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

name = root.rstrip("/").split("/")[-1]
LM_CELLS = [  # tag, arch, max_len, request set, new tokens
    ("ssm-serve", "mamba2-370m", CS.LM_S, CS._ssm_pending, CS.SSM_MAX_NEW),
    ("hybrid-serve", "hymba-1.5b", CS.HYB_CACHE, CS._hybrid_pending,
     CS.HYB_MAX_NEW),
]


def digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


# no first-use build inside a timing
build.build(["ssd_scan", "flash_attention", "decode_attention", "argmax"]
            if LM_ONLY else None)
for tag, arch, max_len, pending_of, max_new in LM_CELLS:
    cfg = get_arch(arch)
    server = Server(cfg, slots=CS.LM_B, max_len=max_len, seed=CS.SEED)
    pending = pending_of(cfg)
    server.admit(-1, pending[0][1][:64], 4)      # warm-up, as the phases
    while server.active.any():
        server.step()
    server.reset()
    for run in range(passes):
        torch.cuda.synchronize()
        SSD.launches = 0
        t0 = time.perf_counter()
        finished, admit_s, wave_s, _ = serve_lm(server, pending, max_new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = sorted((rid, list(map(int, t))) for rid, t in dict(
            finished).items())
        n_tok = sum(len(t) for _, t in toks)
        print(f"{name:8s} {tag:12s} pass {run}  admission "
              f"{1e3 * np.mean(admit_s):8.3f} ms  wave "
              f"{1e3 * np.mean(wave_s):8.3f} ms  {n_tok / dt:8.1f} tokens/s"
              f"  K9 {SSD.launches}  tokens {digest(toks)}", flush=True)
        server.reset()
    del server
    torch.cuda.empty_cache()
if LM_ONLY:
    sys.exit(0)

cfg = get_arch("swb2000-blstm")
for topc, requests in ((0, 8), (16, 4)):
    CS._serve(cfg, requests=requests, topc=topc)          # warm-up
    for run in range(passes):
        _, pending, finished, wave_s, dt, counts = CS._serve(
            cfg, requests=requests, topc=topc)
        frames = sum(len(f) for _, f in pending)
        hyps = sorted((rid, list(map(int, h))) for rid, h in dict(
            finished).items())
        print(f"{name:8s} serve C={topc:2d}   pass {run}  wave "
              f"{1e3 * np.mean(wave_s):8.3f} ms  {frames / dt:8.1f} frames/s"
              f"  K5 {DK.launches}  hypotheses {digest(hyps)}", flush=True)

params = init_params(LS.param_specs(cfg), 0, torch.device("cuda"))
finalize = DC.finalize
for run in range(passes + 1):                             # the first warms
    got = []

    def recording(*a, **kw):
        out = finalize(*a, **kw)
        got.append([t.cpu().numpy().tolist() for t in out[:2]])
        return out
    with mock.patch.object(DC, "finalize", recording):
        m = evaluate_params(cfg, params, batches=4, batch=8, seq_len=256,
                            var_len=True, beam=8, decode_chunk=8,
                            device=torch.device("cuda"))
    if run:
        print(f"{name:8s} evaluate     pass {run - 1}  "
              f"{m['frames_per_s']:8.1f} frames/s  forward "
              f"{1e3 * m['forward_s']:8.2f} ms  decode "
              f"{1e3 * m['decode_s']:8.2f} ms  hypotheses {digest(got)}",
              flush=True)
