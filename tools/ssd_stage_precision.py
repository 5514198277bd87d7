#!/usr/bin/env python3
"""How precisely each product of the SSD scan sums on the tensor cores,
stage by stage, against f64, on the card.

    python3 tools/ssd_stage_precision.py

The SSD scan (K9) has four products per (chunk, head):

* scores   C B^T             (Q x Q; both operands bf16, products exact)
* W x      the weighted scores times x (Q x P; W f32, x bf16)
* state    (wk . x)^T B      (P x N; wk . x f32, B bf16)
* C h      C times the entering state (Q x P; C bf16, h f32)

On the real inputs of four layers of the full-width mamba2-370m (random
weights from seed 0, ``chip_smoke.py``'s 700-token ssm-serve prompt:
three chunks, the last 188 steps), each product is computed by:

* ``plain``: cuBLAS in f32, the arithmetic of ``ref.ssd_plain``, which
  the held checks compare against;
* ``fma``: one fmaf chain per element on the CUDA cores (bf16 parts);
* ``one1``/``one2``/``one3``: wgmma with one f32 accumulator over the
  whole of k, the f32 operand split into 1, 2 or 3 bf16 parts (hi =
  bf16(v), then bf16 of what it leaves), the parts of one k16 step
  issued one after another, as the first wgmma K9 did;
* ``freshG``: the same in 3 parts (the bf16 x bf16 scores in 1), a
  fresh accumulator for every G wgmma k16 steps (G = 3: the parts of one
  k16 step of the product together), each added to an f32 total on the
  CUDA cores (round to nearest); ``fresh3lo`` issues the parts lo first.

Each is held against the same product in f64 (the f32 operand's exact
value).  Per stage and method it prints the error over the f64 result's
norm (``rel``), the mean |error| in f32 ulps of the f64 result, the mean
signed error in those ulps along the result's sign (``bias``: below 0
means toward zero), and for the two that feed y how many values round to
another bf16 than the f64 result does (``flips``).  The product kernel is
``tools/csrc/tc_dot.cu``, built here with the port's nvcc flags.
"""
import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path; helpers)

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import _segsum, ssd_plain  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LAYERS = (0, 1, 17, 40)
ONE = 1 << 30          # a group past every k: one accumulator
# name: (parts of the f32 operand, k16 steps per accumulator, lo first)
METHODS = {"plain": None, "fma": (3, 0, False), "one1": (1, ONE, False),
           "one2": (2, ONE, False), "one3": (3, ONE, False),
           "fresh1": (3, 1, False), "fresh3": (3, 3, False),
           "fresh12": (3, 12, False), "fresh3lo": (3, 3, True)}


def load_tc_dot():
    src = ROOT / "tools" / "csrc" / "tc_dot.cu"
    out = build.BUILD_DIR / "libtc_dot.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.cuda_tool(), *build.NVCC_FLAGS, "-I",
                    str(build._PKG / "kernels" / "csrc"), "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(out)).tc_dot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


TC_DOT = None


def pad(t, rows, cols):
    return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                       0, rows - t.shape[0]))


def up(n, m=64):
    return -(-n // m) * m


def parts(v, n):
    """v (f32) as n bf16 parts: hi = bf16(v), then bf16 of what is left."""
    out, rest = [], v.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16)
        out.append(p)
        rest = rest - p.float()
    return out


def interleave(ts):
    """(R, K) tensors -> (R, K len(ts)): their k16 steps one after another."""
    R, K = ts[0].shape
    return torch.stack([t.reshape(R, K // 16, 16) for t in ts],
                       dim=2).reshape(R, K * len(ts)).contiguous()


def tc(a_parts, b, group):
    """sum over the parts of a_p . b^T on the card by tc_dot: a_p (M, K)
    bf16, b (N, K) bf16."""
    M, K = a_parts[0].shape
    N = b.shape[0]
    Mp, Np, Kp = up(M), up(N), up(K)
    A = interleave([pad(p, Mp, Kp) for p in a_parts])
    B = interleave([pad(b, Np, Kp)] * len(a_parts))
    D = torch.empty(Mp, Np, dtype=torch.float32, device=A.device)
    rc = TC_DOT(A.data_ptr(), B.data_ptr(), D.data_ptr(), Mp, Np,
                Kp * len(a_parts), group,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"tc_dot failed: cudaError {rc}")
    return D[:M, :N]


def product(a32, b16, method, exact_a=False):
    """a32 (M, K) f32, b16 (N, K) bf16 -> a . b^T f32; ``exact_a``: a32
    holds bf16 values (one part, the k16 steps per accumulator over 3)."""
    if method == "plain":
        return a32.float() @ b16.float().T
    n, group, lo_first = METHODS[method]
    if exact_a:
        n, group = 1, max(group // 3, 1) if group not in (0, ONE) else group
    ps = parts(a32, n)
    return tc(ps[::-1] if lo_first else ps, b16, group)


class Stats:
    def __init__(self):
        self.sq_err = self.sq_ref = 0.0
        self.ulp_abs = self.ulp_signed = 0.0
        self.count = 0
        self.flips = 0

    def add(self, got, want, flips):
        got, want = got.double(), want.double()
        e = got - want
        self.sq_err += float((e * e).sum())
        self.sq_ref += float((want * want).sum())
        ok = want.abs() > 1e-30
        ulp = torch.ldexp(torch.ones_like(want[ok]),
                          torch.frexp(want[ok]).exponent - 24)
        u = e[ok] / ulp
        self.ulp_abs += float(u.abs().sum())
        self.ulp_signed += float((u * want[ok].sign()).sum())
        self.count += int(ok.sum())
        if flips:
            self.flips += int((got.to(torch.bfloat16)
                               != want.to(torch.bfloat16)).sum())

    def row(self):
        n = max(self.count, 1)
        return (f"rel {(self.sq_err / max(self.sq_ref, 1e-300)) ** 0.5:.3e}  "
                f"|err| {self.ulp_abs / n:7.3f} ulp  bias "
                f"{self.ulp_signed / n:+7.3f} ulp")


def main():
    global TC_DOT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    TC_DOT = load_tc_dot()
    cfg = get_arch("mamba2-370m")
    params = Server(cfg, slots=1, max_len=1024, seed=CS.SEED).params
    tokens = torch.as_tensor(CS._ssm_pending(cfg)[0][1][None]).cuda()
    inputs = []

    def capture(*args, chunk):
        inputs.append(args)
        return ssd_plain(*args, chunk=chunk)

    with mock.patch.object(SSD, "ssd", capture):
        TT.prefill(cfg, params, tokens)
    Q = cfg.ssm.chunk
    stats = {(s, m): Stats() for s in ("scores", "W x", "state", "C h")
             for m in METHODS}
    for li in LAYERS:
        x, dt, A, Bm, Cm = inputs[li]
        S, H = x.shape[1], x.shape[2]
        h64 = torch.zeros(H, Bm.shape[-1], x.shape[3], dtype=torch.float64,
                          device="cuda")
        for c0 in range(0, S, Q):
            L = min(Q, S - c0)
            C, Bk = Cm[0, c0:c0 + L, 0], Bm[0, c0:c0 + L, 0]   # (L, N)
            sc64 = C.double() @ Bk.double().T
            for m in METHODS:
                stats["scores", m].add(product(C, Bk, m, True), sc64,
                                       False)
            d = dt[0, c0:c0 + L]                               # (L, H)
            dA = d * A
            seg = _segsum(dA[None])[0]                         # (H, L, L)
            W = (C.float() @ Bk.float().T) * torch.exp(seg) * d.T[:, None]
            after = torch.flip(torch.cumsum(torch.flip(dA, [0]), 0), [0])
            after = torch.nn.functional.pad(after[1:], (0, 0, 0, 1))
            wk = torch.exp(after) * d                          # (L, H)
            for h in range(H):
                xh = x[0, c0:c0 + L, h]                        # (L, P) bf16
                xT = xh.T.contiguous()
                y64 = W[h].double() @ xh.double()
                v = (wk[:, h, None] * xh.float()).T.contiguous()   # (P, L)
                st64 = v.double() @ Bk.double()                # (P, N)
                BkT = Bk.T.contiguous()
                hT = h64[h].T.float().contiguous()             # (P, N)
                ch64 = C.double() @ hT.double().T              # (L, P)
                for m in METHODS:
                    stats["W x", m].add(product(W[h], xT, m), y64, True)
                    stats["state", m].add(product(v, BkT, m), st64, False)
                    if c0:
                        stats["C h", m].add(product(hT, C, m), ch64.T,
                                            True)
                decay = torch.exp(dA[:, h].double().sum())
                h64[h] = decay * h64[h] + (
                    (wk[:, h, None].double() * Bk.double()).T
                    @ xh.double())
        print(f"[layer {li}] done", flush=True)
    for stage in ("scores", "W x", "state", "C h"):
        for m in METHODS:
            s = stats[stage, m]
            fl = (f"  flips {s.flips} of {s.count}"
                  if stage in ("W x", "C h") else "")
            print(f"{stage:6s} {m:7s} {s.row()}{fl}", flush=True)


if __name__ == "__main__":
    main()
