"""Causal, sliding-window or full GQA flash attention: the wrapper of the
K11 port, the prefill attention of the dense, vlm, hybrid and MoE
families and the encoder, self- and cross-attention of the encdec
family.

``flash_attention`` has the contract of ``repro.kernels.flash_attention.
flash_attention``: q (B, Sq, H, E), k/v (B, Sk, KV, E) -> (B, Sq, H, E)
in q's dtype, GQA groups of M = H / KV query heads per KV head, query row
s at position ``q_offset + s``; with ``causal`` it admits key t <= that
position and, with a ``window`` > 0, position - t < window (a window past
every position, such as the model's ``GLOBAL_WINDOW``, is full
attention; without ``causal`` the window plays no part, as in the
reference).  Scores, softmax and accumulator are f32.  One extension: any
Sq and Sk are accepted (the Pallas kernel asserts Sq % block_q == 0).

On a CUDA tensor it launches ``csrc/flash_attention.cu`` and counts one
launch (``launches``); on a CPU tensor it runs the plain version
(``ref.flash_attention_plain``).  It never falls back from the card to
the plain path.  The kernel rounds p to bf16 once before p·v, as the
reference model's prefill does, and keeps the row sum in f32: it matches
the all-f32 plain version within the bf16 output's tolerance, 2e-2
normalised per row (1e-2 held on the card).

Training: where grad mode is on and an input requires a gradient, the
call goes through an autograd Function whose forward is the launch and
whose backward recomputes the plain version on the saved q, k, v and
differentiates it (the reference differentiates its jnp attention; the
JAX kernel has no backward).  The raw launch raises on such an input, so
no gradient stops at the kernel's output unseen.

The work is cut by :func:`plan`, a rule of the shape and the SM count:
items of 192 or 128 flattened (position, head) rows (three or two
consumer warpgroups of 64 rows) or, where such items would leave SMs
idle, of 64 rows whose key walk two warpgroups share, merged in shared
memory.  E = 160 (stablelm-12b) keeps its tiles 192 columns wide, the
columns past 160 zeros, and takes 128-row items only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import (on_card, plain_path,
                                 require_kernel_device,
                                 require_no_grad, wants_grad)
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_plain

launches = 0          # K11 launches (one per flash_attention on the card)

HEAD_DIMS = (32, 64, 128, 160)    # the kernel's instantiations of E
BK = 64                       # keys per K/V tile
# rows of an item, largest first: three consumer warpgroups of 64 rows (at
# E <= 64 only: the accumulators of E = 128 do not fit), two, or one
# shared by two warpgroups that walk every other key tile (at E <= 128
# only: E = 160's 192-column tiles leave no room for their merge)
ITEM_ROWS = (192, 128, 64)

_P = ctypes.c_void_p
_I = ctypes.c_int


def kernel_window(window, *, causal: bool, q_offset: int, Sq: int) -> int:
    """The window as the kernel takes it: 0 (none) without ``causal``, for
    a window <= 0 or None, and for a window past every query position —
    so the model's ``GLOBAL_WINDOW`` = 2**30 never enters the kernel's
    position arithmetic."""
    w = 0 if window is None else int(window)
    if not causal or w <= 0 or w >= q_offset + Sq:
        return 0
    return w


class Plan(NamedTuple):
    rows: int           # flattened (position, head) rows of an item
    tiles: int          # row tiles of ``rows`` per (b, KV head)
    items: int          # blocks of the launch: tiles * B * KV


def item_rows(E: int) -> tuple:
    """The item sizes of ``ITEM_ROWS`` the kernel has at head_dim E."""
    return tuple(r for r in ITEM_ROWS
                 if not (r == 192 and E > 64 or r == 64 and E > 128))


def plan(B, Sq, KV, M, E, sms) -> Plan:
    """The launch of one call: items of the most rows of
    :func:`item_rows` whose count ``B * KV * ceil(Sq * M / rows)`` still
    reaches ``sms``, else the fewest (64 rows, whose halved key chains
    fill a short grid; 128 at E = 160).  At the serving shapes on 132
    SMs: hymba-1.5b's S = 1500 200 items of 192, granite's S = 700 136 of
    128, smollm-360m's S = 600 145 of 64 — the fastest item size measured
    at each (PERF.md)."""
    sizes = item_rows(E)
    for rows in sizes:
        tiles = -(-Sq * M // rows)
        if rows == sizes[-1] or tiles * B * KV >= sms:
            return Plan(rows, tiles, tiles * B * KV)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,E), k/v (B,Sk,KV,E); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, E = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != E or KV < 1 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H a multiple of KV)")
    if Sq < 1 or Sk < 1 or q_offset < 0:
        raise ValueError(f"need Sq, Sk >= 1 and q_offset >= 0; got Sq={Sq}, "
                         f"Sk={Sk}, q_offset={q_offset}")
    if E not in HEAD_DIMS:
        raise ValueError(f"head_dim {E} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if window and q_offset + Sq - window >= Sk:
        raise ValueError(f"window {window}: query position "
                         f"{q_offset + Sq - 1} admits no key of {Sk}")


class _FlashAttention(torch.autograd.Function):
    """K11 forward; backward by autograd through ``flash_attention_plain``
    recomputed on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset)
        return _launch(q, k, v, causal=causal, window=window,
                       q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        causal, window, q_offset = ctx.args
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = flash_attention_plain(
                *ins, causal=causal, q_offset=q_offset,
                window=0 if window is None else int(window))
            want = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=0,
                    q_offset: int = 0):
    """q (B, Sq, H, E) bf16, k/v (B, Sk, KV, E) bf16 -> (B, Sq, H, E)."""
    q_offset = int(q_offset)
    if plain_path(q):
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset,
            window=0 if window is None else int(window))
    if wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _launch(q, k, v, *, causal, window, q_offset):
    """One K11 launch on the card (no autograd)."""
    global launches
    require_no_grad("flash_attention", q, k, v)
    win = kernel_window(window, causal=causal, q_offset=q_offset,
                        Sq=q.shape[1])
    _check(q, k, v, win, q_offset)
    require_kernel_device(q)
    B, Sq, H, E = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             f"aligned bf16 tensor on {dev}, got {t.dtype} "
                             f"on {t.device} (contiguous: "
                             f"{t.is_contiguous()})")
    Sk, KV = k.shape[1], k.shape[2]
    M = H // KV
    pl = plan(B, Sq, KV, M, E,
              _sm_count(dev.index if dev.index is not None
                        else torch.cuda.current_device()))
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 9
                                        + [ctypes.c_float, _I, _P])
        lib.flash_attention.restype = _I
    with on_card(q):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk,
            KV, M, E, int(bool(causal)), win, q_offset,
            float(np.float32(1.0 / np.sqrt(E))), pl.rows,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    launches += 1
    return out
