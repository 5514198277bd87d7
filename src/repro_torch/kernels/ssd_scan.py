"""The mamba-2 chunked SSD scan: the wrapper of the K9 port.

``ssd`` has the contract of ``repro.kernels.ssd_scan.ssd`` — x (B, S, H,
P), dt (B, S, H) f32, A (H,) f32, B/C -> (y (B, S, H, P) in x's dtype,
the final state (B, H, N, P) f32), the state starting at zero, the chunk
Q = min(chunk, S) — with two extensions: any S is accepted (a ragged last
chunk is masked, which equals the reference jnp path's zero-dt padding;
the Pallas kernel asserts S % Q == 0), and B/C may be given per group,
(B, S, G, N) with head h reading group h // (H // G), so the group
broadcast is never materialised (G = H is the reference's signature).

On a CUDA tensor it launches the kernel (``csrc/ssd_scan.cu``: two
launches, the chunk states then the outputs, the chunks in parallel as
``ssd_plan`` lays them out; bf16 products on the tensor cores, f32
inputs on the CUDA cores) and counts one launch per call (``launches``);
on a CPU tensor it runs the plain version (``ref.ssd_plain``).  It never
falls back from the card to the plain path.

Training: where grad mode is on and an input requires a gradient, the
call goes through an autograd Function whose forward is the launch and
whose backward recomputes ``ssd_plain`` on the saved inputs and
differentiates it, to x, dt, A, Bm and Cm (an unused final state counts
as a zero gradient); the raw launch raises on such an input.
:func:`ssd_learners` folds a leading learner axis into the heads and
groups (one launch for every learner) and unfolds y and the state.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import (on_card, plain_path,
                                 require_kernel_device,
                                 require_no_grad, wants_grad)
from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_plain

launches = 0          # K9 calls on the card (one per ssd, both launches)

MAX_CHUNK = 256       # the kernel scans one chunk inside a 256-thread CTA
MAX_STATE = 128       # the widest state tile (N padded to 32, 64 or 128)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def ssd_plan(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
             n_sm: int) -> dict:
    """How a bf16 call runs on the card: the chunks, the work items (row,
    chunk, head), the channels of P an output CTA owns (``p_tile``) and
    the scratch.  An output CTA computes a tile's scores and weights once
    for all its channels; P is cut into slices of 32 channels (each CTA
    then computing the same scores) where P needs no more or where the
    items fill at most half of the card's ``n_sm`` SMs, else 64 (f32 calls
    take 64 whatever the plan says)."""
    Q = min(Q, S)
    chunks = -(-S // Q)
    items = B * chunks * H
    return dict(chunks=chunks, items=items,
                p_tile=32 if P <= 32 or 2 * items <= n_sm else 64,
                scratch_bytes=4 * items * (P * N + 1))


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


_entry = None         # the bound ssd_scan, once built
_n_sm = 0
_raw_stream = None


def _ssd_entry():
    """The bound ``ssd_scan`` (argtypes set once), the SM count and the
    raw current-stream accessor, as ``decode.kernel.argmax_tokens`` has
    them."""
    global _entry, _n_sm, _raw_stream
    if _entry is None:
        fn = build.load("ssd_scan").ssd_scan
        fn.argtypes = [_P] * 8 + [_I] * 9 + [_P]
        fn.restype = _I
        _n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _entry = fn
    return _entry


class _SSD(torch.autograd.Function):
    """K9 forward; backward by autograd through ``ssd_plain`` recomputed
    on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            outs = ssd_plain(*ins, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (gy, gstate))
                     if g is not None]
            want = [t for t in ins if t.requires_grad]
            grads = (iter(torch.autograd.grad([o for o, _ in pairs], want,
                                              [g for _, g in pairs]))
                     if pairs else None)
        return tuple(next(grads) if t.requires_grad and grads else None
                     for t in ins) + (None,)


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x (B, S, H, P) bf16 or f32, dt (B, S, H) f32, A (H,) f32, Bm/Cm
    (B, S, G, N) in x's dtype -> (y (B, S, H, P), state (B, H, N, P)
    f32)."""
    _check(x, dt, A, Bm, Cm, chunk)
    if plain_path(x):
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if wants_grad(x, dt, A, Bm, Cm):
        return _SSD.apply(x, dt, A, Bm, Cm, chunk)
    return _launch(x, dt, A, Bm, Cm, chunk)


def ssd_learners(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """:func:`ssd` over a leading learner axis in one call: x (L, B, S, H,
    P), dt (L, B, S, H), A (L, H), Bm/Cm (L, B, S, G, N) -> (y (L, B, S,
    H, P), state (L, B, H, N, P)).  Learner l's heads become heads l·H ..
    l·H + H - 1 of one (B, S, L·H, P) call and its groups groups l·G ..,
    so head l·H + h reads group l·G + h // (H / G), as each learner's own
    call would (heads are independent in the scan)."""
    L, H = x.shape[0], x.shape[3]

    def fold(a):                      # (L, B, S, n, ...) -> (B, S, L·n, ...)
        return a.movedim(0, 2).flatten(2, 3).contiguous()
    y, state = ssd(fold(x), fold(dt), A.reshape(L * H).contiguous(),
                   fold(Bm), fold(Cm), chunk=chunk)
    return (y.unflatten(2, (L, H)).movedim(2, 0),
            state.unflatten(1, (L, H)).movedim(1, 0))


def _launch(x, dt, A, Bm, Cm, chunk):
    """One K9 call on the card (its two launches; no autograd)."""
    global launches
    require_no_grad("ssd", x, dt, A, Bm, Cm)
    require_kernel_device(x)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if Q > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"chunk {Q} > {MAX_CHUNK} or state {N} > "
                         f"{MAX_STATE}: beyond the kernel's tiles")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected bf16 or f32, got {x.dtype}")
    for name, t, dtype in (("x", x, x.dtype), ("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("Bm", Bm, x.dtype),
                           ("Cm", Cm, x.dtype)):
        if (t.dtype != dtype or t.get_device() != x.get_device()
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    fn = _entry or _ssd_entry()
    plan = ssd_plan(Bsz, S, H, P, G, N, Q, _n_sm)
    y = torch.empty_like(x)
    state = x.new_empty(Bsz, H, N, P, dtype=torch.float32)
    scratch = x.new_empty(plan["scratch_bytes"] // 4, dtype=torch.float32)
    with on_card(x):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                scratch.data_ptr(), Bsz, S, H, P, G, N, Q, plan["p_tile"],
                int(x.dtype == torch.float32),
                _raw_stream(x.get_device()))
    if rc:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    launches += 1
    return y, state
