"""Single-query GQA decode attention: the wrappers of the K7 and K8 ports
and their plain versions.

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
card to the plain path.  The K7 kernel at ``block_s = P`` over
contiguous pages equals the K8 kernel bit for bit (one tile walk).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build

launches = 0          # K7 kernel launches
paged_launches = 0    # K8 kernel launches

NEG_INF = -1e30
NO_WINDOW = 2 ** 30             # a window >= S is full attention
MAX_M, MAX_E, MAX_BLOCK_S = 16, 256, 256
SMEM_LIMIT = 232448             # opt-in shared memory of one CTA
_THREADS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        lib.decode_attention.argtypes = ([_P] * 6 + [_I] * 8
                                         + [ctypes.c_float, _P])
        lib.decode_attention.restype = _I
        lib.paged_decode_attention.argtypes = ([_P] * 7 + [_I] * 9
                                               + [ctypes.c_float, _P])
        lib.paged_decode_attention.restype = _I
    return lib


def smem_bytes(block_s: int, M: int, E: int) -> int:
    """Dynamic shared memory of one CTA: double-buffered k and v tiles
    (rows padded by 8 bf16), the f32 query block and one f32 row of
    tile probabilities per warp."""
    return 4 * block_s * (E + 8) * 2 + M * E * 4 + (_THREADS // 32) * block_s * 4


def auto_block_s(S: int) -> int:
    """The dense kernel's tile: 128 rows, or the next power of two >= S
    (at least 16) for a shorter cache."""
    return min(128, max(16, 1 << max(int(S) - 1, 0).bit_length()))


def _scale(E: int) -> float:
    return float(np.float32(1.0 / np.sqrt(E)))


def _window(window) -> int:
    return NO_WINDOW if window is None else int(window)


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


def _check_common(q, cache, k_new, v_new, block_s):
    require_kernel_device(q)
    B, one, H, E = q.shape
    KV = cache.shape[2]
    if one != 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} vs {KV} KV heads")
    M = H // KV
    if not (1 <= M <= MAX_M and 8 <= E <= MAX_E and E % 8 == 0
            and 1 <= block_s <= MAX_BLOCK_S):
        raise ValueError(f"unsupported group M={M} / head_dim E={E} / tile "
                         f"{block_s} (M <= {MAX_M}, E % 8 == 0 and E <= "
                         f"{MAX_E}, tile <= {MAX_BLOCK_S})")
    if smem_bytes(block_s, M, E) > SMEM_LIMIT:
        raise ValueError(f"tile {block_s} x E {E} exceeds the kernel's "
                         f"{SMEM_LIMIT} B of shared memory")
    if (k_new is None) != (v_new is None):
        raise ValueError("pass both k_new and v_new, or neither")
    dev = q.device
    _check("q", q, (B, 1, H, E), torch.bfloat16, dev)
    if k_new is not None:
        _check("k_new", k_new, (B, 1, KV, E), torch.bfloat16, dev)
        _check("v_new", v_new, (B, 1, KV, E), torch.bfloat16, dev)
    return B, H, KV, M, E


def _pos_win(pos, window):
    pos, win = int(pos), _window(window)
    if pos < 0 or win < 1:
        raise ValueError(f"pos {pos} must be >= 0 and window {win} >= 1")
    return pos, win


def decode_attention(q, k_cache, v_cache, pos, *, window=None, k_new=None,
                     v_new=None, block_s=None):
    """q (B, 1, H, E) vs cache (B, S, KV, E) -> (B, 1, H, E).

    ``block_s`` is the kernel's tile (rows of the cache per step of its
    walk); None picks :func:`auto_block_s`.  It does not change the
    function, only the f32 rounding order."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    k_new=k_new, v_new=v_new)
    S = k_cache.shape[1]
    block_s = auto_block_s(S) if block_s is None else int(block_s)
    B, H, KV, M, E = _check_common(q, k_cache, k_new, v_new, block_s)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, t, (B, S, KV, E), torch.bfloat16, q.device)
    pos, win = _pos_win(pos, window)
    out = torch.empty_like(q)
    rc = _lib().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(), out.data_ptr(),
        B, S, KV, M, E, block_s, pos, win, _scale(E),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention launch failed: cudaError {rc}")
    launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *,
                           window=None, k_new=None, v_new=None):
    """q (B, 1, H, E) vs a page pool (n_pages, P, KV, E) through
    ``page_table`` (B, W) int32 -> (B, 1, H, E).  Entries of a table row
    past the pages that hold positions <= pos are never read; an entry
    outside [0, n_pages) reads zeros rather than memory outside the
    pool."""
    global paged_launches
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          pos, window=window, k_new=k_new,
                                          v_new=v_new)
    n_pages, P = k_pages.shape[0], k_pages.shape[1]
    B, H, KV, M, E = _check_common(q, k_pages, k_new, v_new, P)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(name, t, (n_pages, P, KV, E), torch.bfloat16, q.device)
    W = page_table.shape[-1]
    _check("page_table", page_table, (B, W), torch.int32, q.device)
    pos, win = _pos_win(pos, window)
    out = torch.empty_like(q)
    rc = _lib().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(), out.data_ptr(),
        B, n_pages, P, W, KV, M, E, pos, win, _scale(E),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {rc}")
    paged_launches += 1
    return out
