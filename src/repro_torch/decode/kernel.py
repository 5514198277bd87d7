"""The CTC prefix-beam frame step and the LM token selector: the wrappers
of the K5 and K6 ports.

``beam_frame_step`` has the contract of ``repro.decode.kernel
.beam_frame_step``: same inputs, and ``(sel, new_pb, new_pnb)``
bit-identical to ``beam.frame_step_scores`` (or to
``beam.frame_step_scores_topc`` when ``0 < topc < V``) under the max
semiring.  ``argmax_tokens`` has the contract of ``repro.decode.kernel
.argmax_tokens``: (B, V) logits -> (B,) int32, bit-identical to
``jnp.argmax`` of the f32-cast rows (first index on ties, the first NaN
wins).  On a CUDA tensor each launches its kernel (``csrc/beam_step.cu``,
``csrc/argmax.cu``) and counts one launch (``launches``,
``argmax_launches``); on a CPU tensor it runs the plain version.
Neither falls back from the card to the plain path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.decode.beam import frame_step_scores, frame_step_scores_topc
from repro_torch.device import require_kernel_device
from repro_torch.kernels import build

launches = 0          # kernel launches (one per beam_frame_step on the card)
argmax_launches = 0   # K6 launches (one per argmax_tokens on the card)

MAX_BEAM = 16                   # per-parent tables in the kernel's smem
SMEM_BYTES = 200 * 1024         # dynamic shared memory a CTA may ask
                                # (beside ~10 KB of static)
BEAM_THREADS = 512              # beam_step.cu's THREADS (16 warps)
BEAM_MAX_SLICES = 8             # beam_step.cu's MAX_SLICES: CTAs a row
BEAM_MIN_SLICE = BEAM_THREADS   # tokens a CTA at least holds

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)       # off the per-call path
def beam_slices(B: int, V: int, n_sm: int) -> int:
    """CTAs (one cluster) per row of K5: up to BEAM_MAX_SLICES, as many as
    B·S ≤ n_sm (the card's SMs) allows, and no more than leave each CTA
    BEAM_MIN_SLICE tokens of the row."""
    return max(1, min(BEAM_MAX_SLICES, n_sm // B, V // BEAM_MIN_SLICE))


def beam_bounds(V: int, S: int) -> list:
    """The token ranges [lo, hi) of one row's S slices as beam_step.cu cuts
    it: slice s holds [V s // S, V (s + 1) // S)."""
    return [(V * s // S, V * (s + 1) // S) for s in range(S)]


def smem_bytes(beam: int, vocab: int, topc: int, slices: int = 1) -> int:
    """Dynamic shared memory of one CTA (beam_step.cu's ``smem_bytes``):
    the widest slice of the log-prob row in 32-token words, plus when
    pruned the buffer of tokens to rank, the CTA's top-C list, CTA 0's
    copy of every CTA's, the warps' lists and the (K, C+1) candidate
    grid."""
    words = -(-(-(-vocab // slices)) // 32)
    if topc:
        return 4 * (32 * words + 2 * BEAM_THREADS + 4 * topc
                    + 2 * slices * topc + 2 * (BEAM_THREADS // 32) * topc
                    + beam * (topc + 1) + beam * topc)
    return 4 * 32 * words


def beam_cand_bytes(beam: int, vocab: int, topc: int = 0) -> int:
    """f32 bytes per batch row of the beam step's candidate working set,
    the reference's formula (``repro/decode/kernel.py:56``): unpruned ~4
    live (K, V) grids and the (V,) log-prob row; pruned the (K, C+1)
    grids, the row and its top-C workspace.  The quantity K5 works on,
    beside what one CTA holds (:func:`smem_bytes`)."""
    if topc and topc < vocab:
        return (4 * beam * (topc + 1) + 2 * vocab + 2 * topc) * 4
    return (4 * beam * vocab + vocab) * 4


_beam_step = None     # the bound entry point, once built
_beam_n_sm = 0


def _beam_entry():
    """The bound ``beam_step`` (argtypes set once) and the SM count; the
    stream is the raw handle, as for ``argmax_tokens``."""
    global _beam_step, _beam_n_sm
    if _beam_step is None:
        fn = build.load("beam_step").beam_step
        fn.argtypes = [_P] * 9 + [_I] * 8 + [_P]
        fn.restype = _I
        _beam_n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        _beam_step = fn
    return _beam_step


def beam_frame_step(logp, p_b, p_nb, last, phash, plen, *, blank: int,
                    max_len: int, semiring: str, topc: int = 0):
    """logp (B, V) f32; p_b/p_nb (B, K) f32; last/phash/plen (B, K) i32 ->
    ``(sel (B, K) i32, new_pb (B, K) f32, new_pnb (B, K) f32)``.  On the
    card each row is a cluster of ``beam_slices`` CTAs (the result does
    not depend on their count)."""
    global launches
    B, V = logp.shape
    K = p_b.shape[1]
    topc = 0 if topc >= V else topc
    if logp.is_cpu:
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
    fn = _beam_step or _beam_entry()
    S = beam_slices(B, V, _beam_n_sm)
    if smem_bytes(K, V, topc, S) > SMEM_BYTES:
        raise ValueError(f"vocab {V} (topc {topc}) over {S} slices exceeds "
                         f"the kernel's {SMEM_BYTES} B of shared memory")
    for name, t, shape, dtype in (
            ("logp", logp, (B, V), torch.float32),
            ("p_b", p_b, (B, K), torch.float32),
            ("p_nb", p_nb, (B, K), torch.float32),
            ("last", last, (B, K), torch.int32),
            ("phash", phash, (B, K), torch.int32),
            ("plen", plen, (B, K), torch.int32)):
        if (t.shape != shape or t.dtype != dtype or t.get_device() != 0
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} "
                             f"on cuda:0, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    sel = logp.new_empty(B, K, dtype=torch.int32)
    new_pb = logp.new_empty(B, K)
    new_pnb = logp.new_empty(B, K)
    rc = fn(logp.data_ptr(), p_b.data_ptr(), p_nb.data_ptr(), last.data_ptr(),
            phash.data_ptr(), plen.data_ptr(), sel.data_ptr(),
            new_pb.data_ptr(), new_pnb.data_ptr(), B, K, V, blank, max_len,
            1 if semiring == "sum" else 0, topc, S,
            torch._C._cuda_getCurrentRawStream(0))   # cuda:0, checked above
    if rc:
        raise RuntimeError(f"beam_step launch failed: cudaError {rc}")
    launches += 1
    return sel, new_pb, new_pnb


def argmax_ref(logits):
    """The plain token selector: argmax of the f32-cast rows (torch's
    argmax also takes the first maximum and treats NaN as the maximum)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


ARGMAX_THREADS = 256     # argmax.cu's THREADS
MAX_SLICES = 8           # argmax.cu's MAX_SLICES: CTAs (a cluster) per row
_ARGMAX_KIND = {torch.bfloat16: (0, 2), torch.float32: (1, 4)}  # is_f32, size


@functools.lru_cache(maxsize=None)       # off the per-call path
def argmax_slices(B: int, V: int, itemsize: int, n_sm: int) -> int:
    """CTAs per row of K6: up to MAX_SLICES, as many as B·S ≤ n_sm (the
    card's SMs) allows, and no more than give each thread of a CTA one of
    the row's 16-byte vectors."""
    n_vec = V * itemsize // 16
    return max(1, min(MAX_SLICES, n_sm // B, n_vec // ARGMAX_THREADS))


def argmax_bounds(V: int, S: int, itemsize: int, head: int = 0) -> list:
    """The element ranges [lo, hi) of one row's S slices as argmax.cu cuts
    it: whole 16-byte vectors counted from the row's first 16-byte
    boundary, ``head`` elements in; the elements before it go to slice 0,
    those after the last whole vector to slice S - 1."""
    per = 16 // itemsize
    head = min(head, V)
    n_vec = (V - head) // per
    cut = [0] + [head + per * (n_vec * s // S) for s in range(1, S)] + [V]
    return list(zip(cut[:-1], cut[1:]))


_argmax_rows = None      # the bound entry point, once built
_n_sm = 0
_raw_stream = None


def _argmax_entry():
    """The bound ``argmax_rows``; also sets the SM count and the current
    stream's accessor.  ``torch.cuda.current_stream(dev).cuda_stream``
    builds a Stream object every call (~9 µs of a ~27 µs call on the
    H100's host, PERF.md §6); the raw handle is the accessor PyTorch's own
    generated kernels launch on (``torch._C._cuda_getCurrentRawStream``,
    the same stream)."""
    global _argmax_rows, _n_sm, _raw_stream
    if _argmax_rows is None:
        fn = build.load("argmax").argmax_rows
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _P]
        fn.restype = _I
        _n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _argmax_rows = fn
    return _argmax_rows


def argmax_tokens(logits):
    """(B, V) bf16 or f32 logits -> (B,) int32 token ids.  Called once per
    decode group, so the card's path does only what depends on the
    tensor: the library, its bound entry point and the SM count are looked
    up once."""
    global argmax_launches
    if logits.is_cpu:
        return argmax_ref(logits)
    require_kernel_device(logits)
    spec = _ARGMAX_KIND.get(logits.dtype)
    if logits.dim() != 2 or spec is None or not logits.is_contiguous():
        raise ValueError(f"logits: expected contiguous (B, V) bf16 or f32, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    B, V = logits.shape
    fn = _argmax_rows or _argmax_entry()
    out = logits.new_empty(B, dtype=torch.int32)
    rc = fn(logits.data_ptr(), out.data_ptr(), B, V, spec[0],
            argmax_slices(B, V, spec[1], _n_sm),
            _raw_stream(0))                    # cuda:0, checked above
    if rc:
        raise RuntimeError(f"argmax launch failed: cudaError {rc}")
    argmax_launches += 1
    return out
