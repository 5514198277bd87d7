"""Single-query GQA decode attention: the wrappers of the K7 and K8 ports,
their launch plan and their plain versions.

``decode_attention`` has the contract of ``repro.kernels.
decode_attention.decode_attention``: q (B, 1, H, E) against a cache
(B, S, KV, E), GQA groups of M = H / KV queries per KV head, the
canonical mask ``t <= pos`` or, with ``k_new``/``v_new`` (B, 1, KV, E),
the delta variant (old cache ``t < pos`` plus the new column), a sliding
``window`` (``pos - t < window``; None is full attention).  Scores, the
softmax and the accumulator are f32; the output has q's dtype.
``paged_decode_attention`` is the same function over a page pool
(n_pages, P, KV, E) read through a (B, W) int32 page table: position t
lives at ``pool[table[b, t // P], t % P]``.

On a CUDA tensor each wrapper launches ``csrc/decode_attention.cu`` and
counts one launch (``launches`` for K7, ``paged_launches`` for K8); on
a CPU tensor it runs the plain version.  It never falls back from the
card to the plain path.  The launch follows :func:`decode_plan`: each
(batch row, KV head)'s admitted rows — from the window's first row, not
from position 0 — are cut into up to 16 splits of whole ``block_s``-row
tiles (pages, for K8), one CTA each, as many as keep the grid one wave
on the card (:func:`fit_splits`).  The CTAs of one (row, KV head) form
a thread-block cluster: each stores its partial softmax sums in rank
0's shared memory, and rank 0 merges them in rank order in the same
launch.  Both kernels take one plan and one walk, so K7 at
``block_s = P`` over contiguous pages equals K8 bit for bit, and two
calls give the same bits.  The per-call host work is the checks, the
plan (cached) and the ctypes call: the library, its entry points, the
split bound and the raw stream accessor are looked up once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build

launches = 0          # K7 kernel launches
paged_launches = 0    # K8 kernel launches

NEG_INF = -1e30
NO_WINDOW = 2 ** 30             # a window >= S is full attention
MAX_M, MAX_E = 16, 256
DEFAULT_BLOCK_S = 16            # K7's split alignment: the servers' pages
MAX_SPLIT = 16                  # CTAs of one cluster (decode_attention.cu)
MIN_SPLIT_ROWS = 32             # no split is cut shorter than this

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _scale(E: int) -> float:
    return float(np.float32(1.0 / np.sqrt(E)))


def _window(window) -> int:
    return NO_WINDOW if window is None else int(window)


class DecodePlan(NamedTuple):
    """One launch of K7 or K8 for one (B, KV) grid and one position."""
    lo: int            # first admitted cache row (the window's start)
    hi: int            # one past the last (pos + 1, or pos in the delta
                       # variant; at most S)
    n_split: int       # CTAs (one cluster) per (batch row, KV head)
    tiles: int         # block_s-row tiles that [lo, hi) touches
    rows: int          # rows of the longest split's tiles


@functools.lru_cache(maxsize=4096)      # a decode step's layers share it
def decode_plan(B: int, KV: int, S: int, E: int, pos: int, window,
                delta: bool, block_s: int, n_fit: int) -> DecodePlan:
    """The launch plan of one call: the admitted rows ``[lo, hi)`` of
    each (batch row, KV head) cut into ``n_split`` splits of whole
    ``block_s``-row tiles — up to ``n_fit``, the most whose B·KV
    clusters the card runs at once (:func:`fit_splits`: one wave), but
    no more than one per ``MIN_SPLIT_ROWS`` rows, one per tile, or
    ``MAX_SPLIT``; then the fewest splits whose longest is no longer
    (the CTAs' time is the longest split's).  The kernel cuts the tiles
    into the splits and sizes its copy rounds from the plan (split k
    takes tiles ``[tiles·k // n_split, tiles·(k + 1) // n_split)`` of
    the range, clipped to it).  An empty range (the delta variant at
    pos 0, or a window of 1) is one split of no rows: the kernel then
    returns the new column's v.  Raises on a canonical call that admits
    no row (a window wholly past the cache)."""
    pos, win = int(pos), _window(window)
    if pos < 0 or win < 1:
        raise ValueError(f"pos {pos} must be >= 0 and window {win} >= 1")
    lo = max(0, pos - win + 1)
    hi = min(S, pos if delta else pos + 1)
    if hi <= lo:
        if not delta:
            raise ValueError(f"no cache row is admitted: pos {pos}, window "
                             f"{win}, {S} rows")
        return DecodePlan(lo, lo, 1, 0, 0)
    tiles = -(-hi // block_s) - lo // block_s
    n = max(1, min(MAX_SPLIT, n_fit, tiles, (hi - lo) // MIN_SPLIT_ROWS))
    per = -(-tiles // n)               # tiles of the longest split
    n = -(-tiles // per)               # the fewest splits that long
    return DecodePlan(lo, hi, n, tiles, per * block_s)


def smem_bytes(plan: DecodePlan, M: int, E: int, paged: bool) -> int:
    """Dynamic shared memory of one CTA of a launch on ``plan``
    (decode_attention.cu's ``layout``): one round of the longest split's
    rows, or two buffers of ``8192 / E`` rows (at most 256) when its rows
    take several rounds, each row's k and v in bf16 — or, if larger, the
    4 warps' and the cluster's f32 partials (acc (M, E), max and sum per
    query head) — then q in f32, the new column's score and k/v, and,
    paged, two page-table slices."""
    def part(n):
        return n * (M * E + 2 * M) * 4

    def align(x):
        return (x + 15) & ~15

    round_max = min(256, 8192 // E)
    rows = min(plan.rows, round_max) or 1
    n_buf = 2 if plan.rows > rows else 1
    total = align(max(n_buf * rows * 2 * E * 2, part(4) + part(plan.n_split)))
    total += align(M * E * 4) + align((M + 2 * E) * 4)
    return total + (align(2 * (rows + 1) * 4) if paged else 0)


# ---------------------------------------------------------------------------
# plain versions (CPU path and the card's oracle)
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k_cache, v_cache, pos, *, window=None,
                         k_new=None, v_new=None):
    """The kernel's function in torch ops, with a full-row f32 softmax
    over the admitted positions only (rows above ``pos`` are not read)."""
    B, _, H, E = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    M = H // KV
    pos, win = int(pos), _window(window)
    delta = k_new is not None
    n = max(0, min(S, pos if delta else pos + 1))
    qg = q.reshape(B, KV, M, E).float()
    scale = _scale(E)
    s = torch.einsum("bgme,btge->bgmt", qg, k_cache[:, :n].float()) * scale
    t = torch.arange(n, device=q.device)
    s = torch.where((pos - t < win)[None, None, None], s,
                    torch.full_like(s, NEG_INF))
    v = v_cache[:, :n].float()
    if delta:
        s_new = torch.einsum("bgme,bge->bgm", qg, k_new[:, 0].float()) * scale
        s = torch.cat([s, s_new[..., None]], dim=-1)
        v = torch.cat([v, v_new.float()], dim=1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgmt,btge->bgme", p, v)
    return o.reshape(B, 1, H, E).to(q.dtype)


def gather_pages(pages, table):
    """Pool (n_pages, P, KV, E) + table (B, W) -> the logical dense cache
    (B, W * P, KV, E)."""
    _, P, KV, E = pages.shape
    B, W = table.shape
    return pages[table.long()].reshape(B, W * P, KV, E)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, pos, *,
                               window=None, k_new=None, v_new=None):
    """The paged function in torch ops: gather the pages that hold
    positions <= pos, then :func:`decode_attention_ref`."""
    P = k_pages.shape[1]
    need = min(page_table.shape[1], int(pos) // P + 1)
    tbl = page_table[:, :need]
    return decode_attention_ref(q, gather_pages(k_pages, tbl),
                                gather_pages(v_pages, tbl), pos,
                                window=window, k_new=k_new, v_new=v_new)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, dev):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {tuple(shape)} {dtype} "
                         f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} (contiguous: {t.is_contiguous()})")


def _fits(t, shape, dtype=torch.bfloat16) -> bool:
    """``t`` is a contiguous ``shape`` ``dtype`` tensor on cuda:0 — the
    per-call check, which builds no string (:func:`_check` names what is
    wrong once it is not)."""
    return (t.shape == shape and t.dtype == dtype and t.is_contiguous()
            and t.get_device() == 0)


def _group(q, KV, block_s):
    """(B, H, M, E) of q against KV heads; raises on a q or a shape the
    kernel does not take."""
    B, one, H, E = q.shape
    M = H // KV
    if one != 1 or H % KV or not (1 <= M <= MAX_M and 8 <= E <= MAX_E
                                  and E % 8 == 0 and block_s >= 1):
        raise ValueError(f"q {tuple(q.shape)} over {KV} KV heads, tile "
                         f"{block_s}: the kernel takes one query row, "
                         f"M = H / KV <= {MAX_M}, E % 8 == 0 and E <= "
                         f"{MAX_E}, tile >= 1")
    if not _fits(q, (B, 1, H, E)):
        _check("q", q, (B, 1, H, E), torch.bfloat16, q.device)
    return B, H, M, E


def _new_column(q, k_new, v_new, B, KV, E):
    """The delta variant's (k_new, v_new) pointers, checked, or nulls."""
    if k_new is None and v_new is None:
        return None, None
    shape = (B, 1, KV, E)
    if k_new is None or v_new is None:
        raise ValueError("pass both k_new and v_new, or neither")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if not _fits(t, shape):
            _check(name, t, shape, torch.bfloat16, q.device)
    return k_new.data_ptr(), v_new.data_ptr()


_dense = _paged = _clusters = None   # the bound entry points, once built
_raw_stream = None
_FIT: dict = {}


def _entries():
    """Bind the library's entry points and the current stream's raw
    accessor, once (``torch.cuda.current_stream(dev).cuda_stream``
    builds a Stream object a call, ~9 µs of the H100 host's time,
    PERF.md §6)."""
    global _dense, _paged, _clusters, _raw_stream
    if _dense is None:
        lib = build.load("decode_attention")
        dense, paged = lib.decode_attention, lib.paged_decode_attention
        dense.argtypes = [_P] * 6 + [_I] * 9 + [ctypes.c_float, _P]
        paged.argtypes = [_P] * 7 + [_I] * 10 + [ctypes.c_float, _P]
        dense.restype = paged.restype = _I
        _clusters = lib.decode_attention_clusters
        _clusters.argtypes = [_I] * 5
        _clusters.restype = _I
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _dense, _paged = dense, paged
    return _dense, _paged


def fit_splits(delta: bool, M: int, E: int, groups: int) -> int:
    """The most splits n (at most ``MAX_SPLIT``) such that ``groups``
    clusters of every size up to n run on the card at once, in the dense
    kernel and in the paged one (``cudaOccupancyMaxActiveClusters`` at
    each one's largest shared memory; at least 1).  Both wrappers take
    this one bound, so their plans agree.  Cached: a call pays one dict
    lookup."""
    key = (delta, M, E, groups)
    n = _FIT.get(key)
    if n is None:
        _entries()
        n = 1
        while n < MAX_SPLIT:
            k = min(_clusters(paged, int(delta), M, E, n + 1)
                    for paged in (0, 1))
            if k < 0:
                raise RuntimeError(f"decode_attention_clusters failed: "
                                   f"cudaError {-k}")
            if k < groups:
                break
            n += 1
        _FIT[key] = n
    return n


def decode_attention(q, k_cache, v_cache, pos, *, window=None, k_new=None,
                     v_new=None, block_s=None):
    """q (B, 1, H, E) vs cache (B, S, KV, E) -> (B, 1, H, E).

    ``block_s`` (None: ``DEFAULT_BLOCK_S``) aligns the kernel's splits:
    each covers whole tiles of ``block_s`` cache rows (:func:`decode_plan`).
    It does not change the function, only the f32 rounding order; at the
    page size it gives the paged kernel's plan and bits."""
    global launches
    if q.is_cpu:
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    k_new=k_new, v_new=v_new)
    require_kernel_device(q)
    fn = _dense or _entries()[0]
    S, KV = k_cache.shape[1], k_cache.shape[2]
    bs = DEFAULT_BLOCK_S if block_s is None else int(block_s)
    B, H, M, E = _group(q, KV, bs)
    cache = (B, S, KV, E)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not _fits(t, cache):
            _check(name, t, cache, torch.bfloat16, q.device)
    kn, vn = _new_column(q, k_new, v_new, B, KV, E)
    delta = kn is not None
    plan = decode_plan(B, KV, S, E, int(pos), window, delta, bs,
                       fit_splits(delta, M, E, B * KV))
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kn, vn,
            out.data_ptr(), B, S, KV, M, E, bs, plan.lo, plan.hi,
            plan.n_split, _scale(E), _raw_stream(0))   # cuda:0, checked
    if rc:
        raise RuntimeError(f"decode_attention launch failed: cudaError {rc}")
    launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *,
                           window=None, k_new=None, v_new=None):
    """q (B, 1, H, E) vs a page pool (n_pages, P, KV, E) through
    ``page_table`` (B, W) int32 -> (B, 1, H, E).  Entries of a table row
    outside the pages that hold admitted positions are never read; an
    entry outside [0, n_pages) reads zeros rather than memory outside the
    pool.  The splits are cut on page edges (``block_s = P``)."""
    global paged_launches
    if q.is_cpu:
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          pos, window=window, k_new=k_new,
                                          v_new=v_new)
    require_kernel_device(q)
    fn = _paged or _entries()[1]
    n_pages, P, KV = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    B, H, M, E = _group(q, KV, P)
    pool = (n_pages, P, KV, E)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not _fits(t, pool):
            _check(name, t, pool, torch.bfloat16, q.device)
    W = page_table.shape[-1]
    if not _fits(page_table, (B, W), torch.int32):
        _check("page_table", page_table, (B, W), torch.int32, q.device)
    kn, vn = _new_column(q, k_new, v_new, B, KV, E)
    delta = kn is not None
    plan = decode_plan(B, KV, W * P, E, int(pos), window, delta, P,
                       fit_splits(delta, M, E, B * KV))
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kn, vn, out.data_ptr(), B, n_pages, P, W,
            KV, M, E, plan.lo, plan.hi, plan.n_split, _scale(E),
            _raw_stream(0))
    if rc:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {rc}")
    paged_launches += 1
    return out
