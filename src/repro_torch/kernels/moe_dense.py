"""The fused dense mixture of experts: the wrapper of the K10 port, the
dense router's FFN of the moe family on the card.

``moe_dense`` has the contract of ``repro.kernels.moe_dense.moe_dense``:
x (T, d), router_w (T, E) combine weights (0 for experts not selected),
wi/wg (E, d, f), wo (E, f, d) -> y (T, d) in x's dtype, y = Σ_e
router_w[:, e] · ffn_e(x), ffn_e(x) = (silu(x wg_e) · x wi_e) wo_e
(``act="swiglu"``) or gelu(x wi_e) wo_e (``act="gelu"``, the tanh
approximation; wg is then not read).  One extension: any T >= 1 (the
Pallas kernel asserts T % tile_t == 0).

On a CUDA tensor it launches ``csrc/moe_dense.cu`` and counts one launch
(``launches``); on a CPU tensor it runs the plain version
(``ref.moe_dense_plain``).  It never falls back from the card to the
plain path.  The kernel computes only the (token, expert) pairs whose
weight is non-zero: its first launch builds the work list on the device
from router_w (:func:`work_list` is its plain version; the wrapper
never waits on the card), the second runs each used expert's FFN on its
tokens (wgmma products, each expert's weights read from device memory
once) and writes each pair's weighted row in f32 to the pair's slot, the
third sums each token's slots in ascending expert order and rounds once;
a token with no non-zero weight gets an exact 0 row.  A zero weight adds
nothing wherever the expert's FFN is finite, so the function is the
dense sum's; where an unselected expert's FFN is not finite, the dense
sum's row is NaN (0 · inf) and the kernel's is not.

The kernel keeps x·wi, x·wg and the hidden times wo as f32 sums of bf16
products where the plain version rounds each product to bf16, as the
reference oracle does: the two agree within the bf16 output's tolerance,
2e-2 of each token row's largest value.  The hidden is rounded once to
bf16, y once.  A token's output is bit-identical whatever T is and
whichever tokens share its tile: every product is the same wgmma shape
over the same k order at any T.

Training: where grad mode is on and an input requires a gradient, the
call goes through an autograd Function whose forward is the launch and
whose backward recomputes the plain version on the saved inputs and
differentiates it, to x, router_w, wi, wg and wo; the raw launch raises
on such an input.  :func:`moe_dense_learners` takes a leading learner
axis L: learner l's experts become experts l·E .. l·E + E - 1 of one
launch over the L·T tokens, whose router weights are zero off each
learner's block (the work list skips those pairs), while the backward
runs the plain version learner-batched (the dense plain version over the
folded (L·T, L·E) weights would do L times the work).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import (on_card, plain_path,
                                 require_kernel_device,
                                 require_no_grad, wants_grad)
from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_dense_plain

launches = 0          # K10 launches (one per moe_dense on the card)
# the learner-folded expert weights' layout copies (moe_dense_learners on
# the card): how many were taken and their bytes
fold_copies = 0
fold_bytes = 0

ACTS = ("swiglu", "gelu")
HIDDEN_PER_CTA = 64   # hidden columns a CTA computes at prefill (32 at decode)
MAX_CLUSTER = 8       # CTAs per cluster at prefill: f / 64 <= 8, so f <= 512
MAX_OUT_PER_CTA = 192  # output columns d / (f / 64) a CTA computes at prefill
MAX_EXPERTS = 1024    # experts the work list's launch takes
DECODE_T = 16         # T up to which an item is all of one expert's tokens
ITEM_ROWS = 64        # rows of an item above DECODE_T

_P = ctypes.c_void_p
_I = ctypes.c_int
# the workspace's parts, in moe_dense_layout's order
_PARTS = ("slots", "tok_nnz", "tok_off", "pair_tok", "pair_slot", "items",
          "n_items", "total")


class WorkList(NamedTuple):
    """The kernel's work list for router weights (T, E): the pairs (a
    token and an expert whose weight is non-zero) in expert-major order,
    each expert's tokens ascending; each pair's slot in token-major
    order (a token's slots follow its experts in ascending order); the
    items, an expert and up to ``item_rows(T)`` of its pairs, in
    expert-major order."""
    counts: torch.Tensor     # (E,) int: pairs of each expert
    pair_tok: torch.Tensor   # (P,) int: the pair's token
    pair_slot: torch.Tensor  # (P,) int: its slot
    tok_nnz: torch.Tensor    # (T,) int: non-zero weights of each token
    tok_off: torch.Tensor    # (T,) int: its first slot
    items: torch.Tensor      # (I, 3) int: expert, first pair, rows


def item_rows(T: int) -> int:
    """Token rows an item holds: all of one expert's at decode (T <= 16),
    else 64 (one wgmma tile)."""
    return 16 if T <= DECODE_T else ITEM_ROWS


def work_list(router_w, rows: int = None) -> WorkList:
    """The plain version of the kernel's first launch (``moe_plan_kernel``
    builds the same lists on the card); used by the CPU tests and checks,
    never on the main path."""
    T, E = router_w.shape
    rows = item_rows(T) if rows is None else rows
    nz = router_w != 0
    counts = nz.sum(0)
    e_idx, t_idx = torch.nonzero(nz.T, as_tuple=True)   # expert-major
    tok_nnz = nz.sum(1)
    tok_off = torch.cumsum(tok_nnz, 0) - tok_nnz
    rank = torch.cumsum(nz.long(), 1) - 1     # e's place among t's experts
    first = torch.cumsum(counts, 0) - counts
    items = [(e, int(first[e]) + j, min(rows, int(counts[e]) - j))
             for e in range(E) for j in range(0, int(counts[e]), rows)]
    return WorkList(counts, t_idx, tok_off[t_idx] + rank[t_idx, e_idx],
                    tok_nnz, tok_off,
                    torch.tensor(items, dtype=torch.long).reshape(-1, 3))


def _check(x, router_w, wi, wg, wo, act):
    if act not in ACTS:
        raise ValueError(f"act {act!r}: expected one of {ACTS}")
    if x.dim() != 2 or router_w.dim() != 2 or wi.dim() != 3:
        raise ValueError(f"expected x (T, d), router_w (T, E), wi (E, d, f); "
                         f"got {tuple(x.shape)}, {tuple(router_w.shape)}, "
                         f"{tuple(wi.shape)}")
    T, d = x.shape
    E, _, f = wi.shape
    if T < 1 or tuple(router_w.shape) != (T, E):
        raise ValueError(f"router_w {tuple(router_w.shape)}: expected "
                         f"({T}, {E}) with T >= 1")
    if tuple(wi.shape) != (E, d, f) or tuple(wg.shape) != (E, d, f) or \
            tuple(wo.shape) != (E, f, d):
        raise ValueError(f"wi/wg {tuple(wi.shape)}, {tuple(wg.shape)} and wo "
                         f"{tuple(wo.shape)} do not match x {tuple(x.shape)} "
                         f"and {E} experts")


def _check_kernel_shapes(d: int, f: int, E: int = 1):
    cl = f // HIDDEN_PER_CTA
    if f % HIDDEN_PER_CTA or not 1 <= cl <= MAX_CLUSTER:
        raise ValueError(f"d_ff {f}: the kernel takes a multiple of "
                         f"{HIDDEN_PER_CTA} up to "
                         f"{HIDDEN_PER_CTA * MAX_CLUSTER}")
    if d % (64 * cl) or d // cl > MAX_OUT_PER_CTA:
        raise ValueError(f"d_model {d}: the kernel splits it over {cl} CTAs "
                         f"in multiples of 64 up to {MAX_OUT_PER_CTA} each")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts: the kernel takes 1 to {MAX_EXPERTS}")


def launch_plan(T: int, d: int, E: int, f: int) -> dict:
    """How a call at these shapes runs on the card (cluster size, columns
    a CTA, rows an item, the persistent clusters, the workspace)."""
    _check_kernel_shapes(d, f, E)
    cl = f // (32 if T <= DECODE_T else 64)
    n = _lib().moe_dense_clusters(T, d, E, f)
    if n < 0:
        raise RuntimeError(f"moe_dense_clusters failed: cudaError {-n}")
    lay = _layout(T, d, E)
    return dict(regime="decode" if T <= DECODE_T else "prefill",
                item_rows=item_rows(T), cluster=cl, hidden_per_cta=f // cl,
                out_per_cta=d // cl, clusters=n, ctas=n * cl,
                slot_bytes=lay["tok_nnz"] - lay["slots"],
                workspace_bytes=lay["total"])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("moe_dense")
    lib.moe_dense.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.moe_dense.restype = _I
    lib.moe_dense_layout.argtypes = [_I] * 3 + [_P]
    lib.moe_dense_layout.restype = _I
    lib.moe_dense_clusters.argtypes = [_I] * 4
    lib.moe_dense_clusters.restype = _I
    lib.moe_dense_plan.argtypes = [_P, _P] + [_I] * 3 + [_P]
    lib.moe_dense_plan.restype = _I
    return lib


@functools.lru_cache(maxsize=1024)
def _layout(T: int, d: int, E: int) -> dict:
    """The workspace's byte offsets (``moe_dense_layout`` owns them)."""
    out = (ctypes.c_size_t * len(_PARTS))()
    rc = _lib().moe_dense_layout(T, d, E, ctypes.cast(out, _P))
    if rc:
        raise RuntimeError(f"moe_dense_layout failed: cudaError {rc}")
    return dict(zip(_PARTS, out))


def _check_device(x, router_w, wi, wg, wo):
    dev = x.device
    for name, t, dtype in (("x", x, torch.bfloat16),
                           ("router_w", router_w, torch.float32),
                           ("wi", wi, torch.bfloat16),
                           ("wg", wg, torch.bfloat16),
                           ("wo", wo, torch.bfloat16)):
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             f"aligned {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous: "
                             f"{t.is_contiguous()})")


def device_work_list(router_w, d: int) -> WorkList:
    """The work list as the kernel's first launch builds it on the card,
    read back (a check of :func:`work_list`'s twin; the main path never
    reads it back)."""
    require_kernel_device(router_w)
    T, E = router_w.shape
    if router_w.dtype != torch.float32 or not router_w.is_contiguous():
        raise ValueError("router_w: expected a contiguous f32 tensor")
    lay = _layout(T, d, E)
    ws = torch.empty(lay["total"], dtype=torch.uint8, device=router_w.device)
    with on_card(router_w):
        rc = _lib().moe_dense_plan(
            router_w.data_ptr(), ws.data_ptr(), T, d, E,
            torch._C._cuda_getCurrentRawStream(router_w.get_device()))
    if rc:
        raise RuntimeError(f"moe_dense_plan failed: cudaError {rc}")
    ws = ws.cpu()

    def part(name, n):
        at = lay[name]
        return ws[at:at + 4 * n].view(torch.int32).long()
    tok_nnz = part("tok_nnz", T)
    P = int(tok_nnz.sum())
    n_items = int(part("n_items", 1))
    items = part("items", 4 * n_items).reshape(-1, 4)[:, :3]
    counts = torch.zeros(E, dtype=torch.long).index_add_(0, items[:, 0],
                                                         items[:, 2])
    return WorkList(counts, part("pair_tok", P), part("pair_slot", P),
                    tok_nnz, part("tok_off", T), items)


class _MoEDense(torch.autograd.Function):
    """K10 forward on the learner-folded operands; backward by autograd
    through ``moe_dense_plain`` recomputed learner-batched on the saved
    (L, ...) inputs."""

    @staticmethod
    def forward(ctx, x, router_w, wi, wg, wo, act, folded):
        ctx.save_for_backward(x, router_w, wi, wg, wo)
        ctx.act = act
        return _launch_folded(x, router_w, folded, act)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = moe_dense_plain(*ins, act=ctx.act)
            want = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None, None)


def _same(a, kept) -> bool:
    """``a`` is the tensor whose fold was kept: the same memory and layout
    as the kept detached view, and the version counter it had then (the
    view shares ``a``'s counter, so the version is kept as an int)."""
    view, version = kept
    return (a.data_ptr() == view.data_ptr() and a.shape == view.shape
            and a.stride() == view.stride() and a._version == version)


def fold_experts(wi, wg, wo, keep=None, slot=None):
    """Learner-stacked expert weights (L, E, ...) -> (L·E, ...) contiguous:
    a view where they are contiguous (L = 1), else a copy.  Given a
    ``keep`` dict and a ``slot`` (the caller's layer) the copy is kept
    there and reused while the same weights come back unchanged (same
    memory, layout, and the version counter each had when the fold was
    kept: an in-place update bumps it and the next call folds afresh),
    so a step's microbatches and the recompute of a checkpointed layer
    take it once; the kept weights hold their memory, so an equal
    address is the same tensor."""
    global fold_copies, fold_bytes
    ws = (wi, wg, wo)
    if all(w.is_contiguous() for w in ws):
        return tuple(w.flatten(0, 1) for w in ws)
    kept = keep.get(slot) if keep is not None else None
    if kept is not None and all(_same(a, k) for a, k in zip(ws, kept[0])):
        return kept[1]
    with torch.no_grad():
        out = tuple(w.detach().contiguous().flatten(0, 1) for w in ws)
    fold_copies += 3
    fold_bytes += sum(w.numel() * w.element_size() for w in out)
    if keep is not None:
        keep[slot] = (tuple((w.detach(), w._version) for w in ws), out)
    return out


def learner_block_weights(router_w):
    """(L, T, E) -> (L·T, L·E) router weights: learner l's tokens weigh
    only its own experts, zero elsewhere."""
    L, T, E = router_w.shape
    out = router_w.new_zeros(L, T, L, E)
    idx = torch.arange(L, device=router_w.device)
    out[idx, :, idx, :] = router_w
    return out.reshape(L * T, L * E)


def moe_dense_learners(x, router_w, wi, wg, wo, *, act: str = "swiglu",
                       keep=None, slot=None):
    """:func:`moe_dense` for L learners at once: x (L, T, d), router_w
    (L, T, E), wi/wg (L, E, d, f), wo (L, E, f, d) (each learner's own
    experts; a strided layer slice of a learner-stacked tree is fine) ->
    y (L, T, d).  On the card one launch of the folded operands
    (:func:`fold_experts`, kept in ``keep`` under ``slot``;
    :func:`learner_block_weights`), through the autograd Function where a
    gradient is wanted; on the CPU the learner-batched plain version."""
    if plain_path(x):
        return moe_dense_plain(x, router_w, wi, wg, wo, act=act)
    folded = fold_experts(wi, wg, wo, keep, slot)
    if wants_grad(x, router_w, wi, wg, wo):
        return _MoEDense.apply(x, router_w, wi, wg, wo, act, folded)
    return _launch_folded(x, router_w, folded, act)


def _launch_folded(x, router_w, folded, act):
    L, T, d = x.shape
    y = _launch(x.reshape(L * T, d), learner_block_weights(router_w),
                *folded, act=act)
    return y.view(L, T, d)


def moe_dense(x, router_w, wi, wg, wo, *, act: str = "swiglu"):
    """x (T, d) bf16, router_w (T, E) f32, wi/wg (E, d, f) bf16, wo
    (E, f, d) bf16 -> y (T, d) bf16."""
    _check(x, router_w, wi, wg, wo, act)
    if plain_path(x):
        return moe_dense_plain(x, router_w, wi, wg, wo, act=act)
    if wants_grad(x, router_w, wi, wg, wo):
        return _MoEDense.apply(x[None], router_w[None], wi[None], wg[None],
                               wo[None], act, (wi, wg, wo))[0]
    return _launch(x, router_w, wi, wg, wo, act=act)


def _launch(x, router_w, wi, wg, wo, *, act):
    """One K10 call on the card (its three launches; no autograd)."""
    global launches
    require_no_grad("moe_dense", x, router_w, wi, wg, wo)
    _check(x, router_w, wi, wg, wo, act)
    require_kernel_device(x)
    T, d = x.shape
    E, _, f = wi.shape
    _check_kernel_shapes(d, f, E)
    _check_device(x, router_w, wi, wg, wo)
    y = torch.empty_like(x)
    ws = torch.empty(_layout(T, d, E)["total"], dtype=torch.uint8,
                     device=x.device)
    with on_card(x):
        rc = _lib().moe_dense(x.data_ptr(), router_w.data_ptr(), wi.data_ptr(),
                              wg.data_ptr(), wo.data_ptr(), y.data_ptr(),
                              ws.data_ptr(), T, d, E, f, int(act == "gelu"),
                              torch._C._cuda_getCurrentRawStream(
                                  x.get_device()))
    if rc:
        raise RuntimeError(f"moe_dense launch failed: cudaError {rc}")
    launches += 1
    return y
