"""The CTC prefix-beam frame step: the wrapper of the K5 port.

``beam_frame_step`` has the contract of ``repro.decode.kernel
.beam_frame_step``: same inputs, and ``(sel, new_pb, new_pnb)``
bit-identical to ``beam.frame_step_scores`` (or to
``beam.frame_step_scores_topc`` when ``0 < topc < V``) under the max
semiring.  On a CUDA tensor it launches ``csrc/beam_step.cu`` and counts
one launch; on a CPU tensor it runs the plain version.  It never falls
back from the card to the plain path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.decode.beam import frame_step_scores, frame_step_scores_topc
from repro_torch.device import require_kernel_device
from repro_torch.kernels import build

launches = 0          # kernel launches (one per beam_frame_step on the card)

MAX_BEAM = 16                   # per-parent tables in the kernel's smem
SMEM_BYTES = 220 * 1024         # dynamic shared memory the kernel may ask

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("beam_step")
    if lib.beam_step.argtypes is None:
        lib.beam_step.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.beam_step.restype = _I
    return lib


def smem_bytes(beam: int, vocab: int, topc: int) -> int:
    """Dynamic shared memory of one CTA: the (V,) log-prob row, plus the
    (K, V) merge-kill bitmap unpruned, or the top-C tables and the
    (K, C+1) candidate grid when pruned."""
    if topc:
        return 4 * (vocab + 2 * topc + beam * (topc + 1) + beam * topc)
    return 4 * (vocab + beam * -(-vocab // 32))


def beam_frame_step(logp, p_b, p_nb, last, phash, plen, *, blank: int,
                    max_len: int, semiring: str, topc: int = 0):
    """logp (B, V) f32; p_b/p_nb (B, K) f32; last/phash/plen (B, K) i32 ->
    ``(sel (B, K) i32, new_pb (B, K) f32, new_pnb (B, K) f32)``."""
    global launches
    B, V = logp.shape
    K = p_b.shape[1]
    topc = 0 if topc >= V else topc
    if logp.device.type == "cpu":
        if topc:
            return frame_step_scores_topc(
                logp, p_b, p_nb, last, phash, plen, blank=blank,
                max_len=max_len, semiring=semiring, topc=topc)
        return frame_step_scores(logp, p_b, p_nb, last, phash, plen,
                                 blank=blank, max_len=max_len,
                                 semiring=semiring)
    require_kernel_device(logp)
    if semiring not in ("max", "sum"):
        raise ValueError(f"semiring must be 'max' or 'sum', got "
                         f"{semiring!r}")
    if not 1 <= K <= min(MAX_BEAM, V) or not 0 <= blank < V or topc < 0:
        raise ValueError(f"unsupported beam {K} / vocab {V} / blank "
                         f"{blank} / topc {topc}")
    if smem_bytes(K, V, topc) > SMEM_BYTES:
        raise ValueError(f"vocab {V} (topc {topc}) exceeds the kernel's "
                         f"{SMEM_BYTES} B of shared memory")
    dev = logp.device
    for name, t, shape, dtype in (
            ("logp", logp, (B, V), torch.float32),
            ("p_b", p_b, (B, K), torch.float32),
            ("p_nb", p_nb, (B, K), torch.float32),
            ("last", last, (B, K), torch.int32),
            ("phash", phash, (B, K), torch.int32),
            ("plen", plen, (B, K), torch.int32)):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    sel = torch.empty(B, K, dtype=torch.int32, device=dev)
    new_pb = torch.empty(B, K, dtype=torch.float32, device=dev)
    new_pnb = torch.empty(B, K, dtype=torch.float32, device=dev)
    rc = _lib().beam_step(
        logp.data_ptr(), p_b.data_ptr(), p_nb.data_ptr(), last.data_ptr(),
        phash.data_ptr(), plen.data_ptr(), sel.data_ptr(), new_pb.data_ptr(),
        new_pnb.data_ptr(), B, K, V, blank, max_len,
        1 if semiring == "sum" else 0, topc,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"beam_step launch failed: cudaError {rc}")
    launches += 1
    return sel, new_pb, new_pnb
