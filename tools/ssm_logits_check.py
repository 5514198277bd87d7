#!/usr/bin/env python3
"""ssm-serve's end-to-end check for three SSD implementations, on the card.

    python3 tools/ssm_logits_check.py [layers]

``chip_smoke.py``'s ssm-serve phase holds the teacher-forced logits (the
prefill's last token and 8 decode steps) of the full-width mamba2-370m
cut to its first 8 layers against the plain path at 2e-2 (normalised).
This tool runs that comparison for K9 (the kernel this tree builds),
``ssd_plain`` and an f64 evaluation of the exact recurrence
(``tools/ssd_precision.ssd_f64_rounded``), each pair side by side, on
the 16-request set's first 8 prompts (random weights from seed 0), fed
8 tokens drawn from seed 0 (the phase feeds the tokens it served, so its
own numbers differ).  It prints, per request, the largest of the 9
normalised differences and all 9, for kernel vs plain, f64 vs plain and
kernel vs f64: how far an SSD whose sums run in another order than the
plain path's lands after the random-init layers amplify its bf16
roundings of y.
"""
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path; helpers)
import ssd_precision as SP  # noqa: E402  (the f64 recurrence)

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import ssd_plain  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402

layers = int(sys.argv[1]) if len(sys.argv) > 1 else CS.SSM_CUT
cfg = get_arch("mamba2-370m")
server = Server(cfg, slots=1, max_len=CS.LM_S, seed=CS.SEED)
pending = CS._ssm_pending(cfg)
srv = CS._layer_cut(server, layers)
g = torch.Generator().manual_seed(CS.SEED)
kernel = SSD.ssd
print(f"mamba2-370m cut to {layers} layers; normalised logits differences "
      f"(the check's tolerance {CS.SSM_Y_TOL})", flush=True)
for rid in range(8):
    prompt = pending[rid][1]
    toks = torch.randint(0, cfg.vocab, (8,), generator=g).tolist()
    out = {}
    for name, f in (("plain", ssd_plain), ("kernel", kernel),
                    ("f64", SP.ssd_f64_rounded)):
        with mock.patch.object(SSD, "ssd", f):
            out[name] = CS._teacher_forced_logits(srv, prompt, toks, 8)
    for a, b in (("kernel", "plain"), ("f64", "plain"), ("kernel", "f64")):
        errs = [CS._norm_err(x, y)[1] for x, y in zip(out[a], out[b])]
        print(f"request {rid} ({len(prompt)} tokens) {a} vs {b}: max "
              f"{max(errs):.4f} {[round(e, 4) for e in errs]}", flush=True)
