"""The mamba-2 chunked SSD scan: the wrapper of the K9 port.

``ssd`` has the contract of ``repro.kernels.ssd_scan.ssd`` — x (B, S, H,
P), dt (B, S, H) f32, A (H,) f32, B/C -> (y (B, S, H, P) in x's dtype,
the final state (B, H, N, P) f32), the state starting at zero, the chunk
Q = min(chunk, S) — with two extensions: any S is accepted (a ragged last
chunk is masked, which equals the reference jnp path's zero-dt padding;
the Pallas kernel asserts S % Q == 0), and B/C may be given per group,
(B, S, G, N) with head h reading group h // (H // G), so the group
broadcast is never materialised (G = H is the reference's signature).

On a CUDA tensor it launches the kernel (``csrc/ssd_scan.cu``) and counts
one launch (``launches``); on a CPU tensor it runs the plain version
(``ref.ssd_plain``).  It never falls back from the card to the plain path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_plain

launches = 0          # K9 launches (one per ssd on the card)

MAX_CHUNK = 256       # the kernel scans one chunk inside a 256-thread CTA
MAX_STATE = 128       # state rows a thread keeps in registers: N / 16 <= 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1:
        raise ValueError(f"expected x (B,S,H,P), dt (B,S,H), A (H,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    Bsz, S, H, P = x.shape
    if S < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got S={S}, "
                         f"chunk={chunk}")
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if Bm.dim() != 4 or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (
            Bsz, S):
        raise ValueError(f"B/C: expected (B,S,G,N) alike, got "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    G = Bm.shape[2]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} B/C groups")


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x (B, S, H, P) bf16 or f32, dt (B, S, H) f32, A (H,) f32, Bm/Cm
    (B, S, G, N) in x's dtype -> (y (B, S, H, P), state (B, H, N, P)
    f32)."""
    global launches
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    require_kernel_device(x)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if Q > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"chunk {Q} > {MAX_CHUNK} or state {N} > "
                         f"{MAX_STATE}: beyond the kernel's tiles")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected bf16 or f32, got {x.dtype}")
    dev = x.device
    for name, t, dtype in (("x", x, x.dtype), ("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("Bm", Bm, x.dtype),
                           ("Cm", Cm, x.dtype)):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    y = torch.empty_like(x)
    state = torch.empty(Bsz, H, N, P, dtype=torch.float32, device=dev)
    lib = build.load("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        lib.ssd_scan.restype = _I
    rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                      state.data_ptr(), Bsz, S, H, P, G, N, Q,
                      int(x.dtype == torch.float32),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    launches += 1
    return y, state
