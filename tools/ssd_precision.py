#!/usr/bin/env python3
"""How far two f32 SSD implementations sit from each other and from an
f64 truth inside the full-width mamba2-370m, on the card.

    python3 tools/ssd_precision.py

Random weights from seed 0, the prompts of ``chip_smoke.py``'s
``ssm-serve`` phase (the first 700 tokens long, a ragged last chunk).
Three SSD implementations are swapped into the prefill in turn: the K9
kernel, its plain version ``ssd_plain`` (f32) and the exact recurrence
evaluated in f64 (``ssd_f64`` below, the truth).  It prints:

1. per layer, for four layers of the 700-token prefill, the error of the
   kernel and of ``ssd_plain`` against the truth on that layer's own
   inputs, normalised by the truth's max-abs: with the inputs cast to
   f32 (y before rounding and the final state) and as served in bf16
   (the final state, and how many bf16 y values round apart, kernel vs
   plain and plain vs the truth);
2. the normalised error of the last-token logits through the first
   1, 2, 4, 8, 16, 32 and 48 layers: kernel vs plain, plain vs truth;
3. the same three pairs through 16 layers for each of the 16 prompts,
   and their medians: how far two f32 SSDs drift apart by chance.

Every model evaluation shares the weights and the prompt, so the
differences are the SSD's rounding alone, carried through the stack.
"""
import dataclasses
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path; helpers)

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import expand_groups, ssd_plain  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

KERNEL = SSD.ssd


def ssd_f64(x, dt, A, Bm, Cm, *, chunk=None):
    """The exact token-by-token recurrence in f64 (chunk is unused)."""
    H = x.shape[2]
    xd, dtd, Ad = x.double(), dt.double(), A.double()
    Bd, Cd = expand_groups(Bm.double(), H), expand_groups(Cm.double(), H)
    h = torch.zeros(x.shape[0], H, Bd.shape[-1], x.shape[3],
                    dtype=torch.float64, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dtd[:, t] * Ad)[:, :, None, None] * h
             + Bd[:, t, :, :, None] * (dtd[:, t, :, None, None]
                                       * xd[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cd[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_f64_rounded(x, dt, A, Bm, Cm, *, chunk=None):
    """``ssd_f64`` with the outputs every SSD returns: y rounded once to
    x's dtype, the state in f32."""
    y, h = ssd_f64(x, dt, A, Bm, Cm)
    return y.to(x.dtype), h.float()


def last_logits(cfg, params, tokens, ssd):
    with mock.patch.object(SSD, "ssd", ssd):
        logits, _ = TT.prefill(cfg, params, tokens)
    return logits[:, -1].float()


def cut(cfg, params, n):
    layers = {k: {kk: v[:n] for kk, v in t.items()}
              for k, t in params["layers"].items()}
    return dataclasses.replace(cfg, n_layers=n), dict(params, layers=layers)


def err(got, want):
    return CS._norm_err(got, want)[1]


def main():
    smi = CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cfg = get_arch("mamba2-370m")
    params = Server(cfg, slots=1, max_len=1024, seed=CS.SEED).params
    pending = CS._ssm_pending(cfg)
    tokens = torch.as_tensor(pending[0][1][None]).cuda()

    inputs = []

    def capture(*args, chunk):
        inputs.append(args)
        return KERNEL(*args, chunk=chunk)

    last_logits(cfg, params, tokens, capture)
    for i in (0, 1, 17, 40):
        x, dt, A, Bm, Cm = inputs[i]
        f32 = (x.float(), dt, A, Bm.float(), Cm.float())
        ty, th = ssd_f64(*f32)
        ky, kh = KERNEL(*f32, chunk=cfg.ssm.chunk)
        py, ph = ssd_plain(*f32, chunk=cfg.ssm.chunk)
        plain_y, plain_h = ssd_plain(x, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        by, bh = KERNEL(x, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        flips = int((by != plain_y).sum())
        flips_f64 = int((ty.to(x.dtype) != plain_y).sum())
        print(f"[layer {i}] vs f64 truth: f32 inputs: y kernel "
              f"{err(ky, ty):.3g} plain {err(py, ty):.3g}; state kernel "
              f"{err(kh, th):.3g} plain {err(ph, th):.3g}; bf16 inputs (as "
              f"served): state kernel {err(bh, th):.3g} plain "
              f"{err(plain_h, th):.3g}, y rounded apart of {x.numel()}: "
              f"kernel vs plain {flips}, plain vs f64 {flips_f64}",
              flush=True)
    for n in (1, 2, 4, 8, 16, 32, cfg.n_layers):
        c, p = cut(cfg, params, n)
        k, pl, tr = (last_logits(c, p, tokens, f)
                     for f in (KERNEL, ssd_plain, ssd_f64_rounded))
        print(f"[depth {n}] last-token logits: kernel vs plain "
              f"{err(k, pl):.4g}, plain vs f64 truth {err(pl, tr):.4g}, "
              f"kernel vs f64 truth {err(k, tr):.4g}", flush=True)
    c, p = cut(cfg, params, 16)
    pairs = []
    for rid, prompt in pending:
        tok = torch.as_tensor(prompt[None]).cuda()
        k, pl, tr = (last_logits(c, p, tok, f)
                     for f in (KERNEL, ssd_plain, ssd_f64_rounded))
        pairs.append((err(k, pl), err(pl, tr), err(k, tr)))
        print(f"[request {rid}, {len(prompt)} tokens] 16-layer logits: "
              f"kernel vs plain {pairs[-1][0]:.4g}, plain vs f64 truth "
              f"{pairs[-1][1]:.4g}, kernel vs f64 truth {pairs[-1][2]:.4g}",
              flush=True)
    med = torch.tensor(pairs).median(dim=0).values.tolist()
    print(f"[16 layers, {len(pairs)} requests] medians: kernel vs plain "
          f"{med[0]:.4g}, plain vs f64 truth {med[1]:.4g}, kernel vs f64 "
          f"truth {med[2]:.4g}", flush=True)

if __name__ == "__main__":
    main()
