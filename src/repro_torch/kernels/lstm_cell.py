"""Fused bidirectional LSTM layer: the wrappers of the K1, K2 and K3 ports.

* ``blstm_layer`` — the inference forward, counterpart of
  ``repro.kernels.lstm_cell._run_fwd`` with ``n_dir=2, stash=False``;
* ``blstm_layer_train`` — K1's stashing variant (``stash=True``), which
  also writes the post-activation gates and the cell states;
* ``blstm_layer_bwd`` — K2, ``_run_bwd`` for both directions;
* ``blstm_layer_train_chunked`` — K1's chunk-entry variant
  (``stash=True, seq_chunk=K``), which keeps only the (h, c) carry
  entering every K-step chunk;
* ``blstm_layer_bwd_chunked`` — K3, ``_run_bwd_chunked`` for both
  directions: per chunk, replay the forward from its entry carry, then
  the reverse steps;
* ``blstm_stack`` — K4, the whole L-layer stack in one launch
  (``repro.kernels.lstm_cell._stack_primal``), inference only,
  bit-identical to the loop of ``blstm_layer``; ``stack_plan`` — how its
  recurrences run: on clusters of 16 CTAs holding Wh in shared memory, or
  (where H does not split) on one 512-thread block per item;
* ``blstm_sequence`` — the differentiable layer, a
  ``torch.autograd.Function`` over a forward and its backward (the
  stashing pair, or with ``seq_chunk`` the chunked pair), mirroring
  ``_blstm_vjp_fwd``/``_blstm_vjp_bwd`` (``lstm_cell.py:1026-1050``);
* ``chunk_length`` and ``stash_bytes`` — the chunk-length rule and the
  residual-stash accounting of the reference;
* ``recur_plan`` — how the training wrappers launch their forward
  recurrences: streaming Wh from device memory (short launches, 8-row
  tiles), or with Wh resident in the shared memory of clusters of 16
  CTAs (long launches), the same bits either way;
* ``lstm_sequence`` — ONE direction, forward or ``reverse``, the
  counterpart of ``repro.kernels.lstm_cell.lstm_sequence`` under its
  custom VJP ``_lstm_vjp`` (``lstm_cell.py:954-1005``): inference is one
  launch of K1 (``lstm_layer``), training K1-stash + K2 or, under
  ``seq_chunk``, K1-chunk + K3 (``lstm_layer_train``,
  ``lstm_layer_bwd``, ``lstm_layer_train_chunked``,
  ``lstm_layer_bwd_chunked``), behind ``_LstmSequence``.  These are the
  same kernels launched with one direction (the sources' ``nd = 1``):
  ``blstm_sequence`` equals the concatenation of the forward and the
  reversed ``lstm_sequence`` bit for bit, forward and gradients (dx
  being the bf16 sum of the two passes' dx, as autograd adds them).

Every tensor may carry a leading learner axis (x (L, B, T, D), weights
(L, D, 4H), ..., lengths (L, B)): the learners are one more axis of each
kernel's grid, as ``jax.vmap`` of a ``pallas_call`` is.  On CUDA tensors
the wrappers launch the kernels of ``csrc/lstm_fwd.cu``,
``csrc/lstm_bwd.cu``, ``csrc/lstm_bwd_chunked.cu`` and
``csrc/lstm_stack.cu`` and count their launches; on CPU and fake tensors
(``repro_torch.device.plain_path``), or with ``plain=True`` (the oracle
a check asks for by name), they run the plain versions of
``kernels.ref``.  They never fall back from the card to the
plain path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.device import (on_card, plain_path,
                                 require_kernel_device)
from repro_torch.kernels import build
from repro_torch.kernels.ref import (blstm_layer_ref, blstm_stack_plain,
                                     lstm_direction_bwd_chunked_ref,
                                     lstm_direction_bwd_ref,
                                     lstm_direction_chunk_fwd_ref,
                                     lstm_direction_ref,
                                     lstm_direction_train_ref, stash_dtype)

launches = 0          # blstm_layer calls that launched the inference kernel
stash_launches = 0    # blstm_layer_train calls that launched the stash kernel
bwd_launches = 0      # blstm_layer_bwd calls that launched K2
chunk_launches = 0    # blstm_layer_train_chunked calls that launched K1-chunk
chunked_bwd_launches = 0   # blstm_layer_bwd_chunked calls that launched K3
stack_launches = 0    # blstm_stack calls that launched K4
# the one-direction launches of the same kernels (lstm_sequence's path)
uni_launches = 0             # lstm_layer: K1, inference
uni_stash_launches = 0       # lstm_layer_train: K1-stash
uni_bwd_launches = 0         # lstm_layer_bwd: K2
uni_chunk_launches = 0       # lstm_layer_train_chunked: K1-chunk
uni_chunked_bwd_launches = 0     # lstm_layer_bwd_chunked: K3

_P = ctypes.c_void_p
_I = ctypes.c_int
_STASH_KIND = {torch.float32: 1, torch.bfloat16: 2}
_ENTRY_KIND = {torch.float32: 3, torch.bfloat16: 4}


def chunk_length(T: int, seq_chunk: int) -> int:
    """The chunk length K that ``seq_chunk`` selects at sequence length T
    (``auto_tile``'s rule for K, ``repro/kernels/lstm_cell.py:246-291``):
    an explicit K > 0 is clamped to T; a negative value (-1, auto)
    starts at min(256, next_pow2(T)) and halves while the time padding it
    induces, round_up(T, K) - T, exceeds T/8, down to 16 frames.  The
    time axis is then padded to a multiple of K.

    ``auto_tile`` first halves K (and the batch tile) until the TPU
    kernels' VMEM estimate fits its budget; that rule describes the TPU's
    scratch memory and has no meaning here: K3 keeps its chunk buffers in
    device memory and its batch tile is the recurrence kernels'
    (:func:`block_rows`).  So at the paper's width the port's K can be
    larger than the reference's; T = 2000 gives K = 256, T_pad = 2048."""
    if not seq_chunk:
        raise ValueError("seq_chunk 0 selects the per-step stash, no chunk")
    T = max(T, 1)
    if seq_chunk > 0:
        return min(seq_chunk, T)
    K = min(256, 1 << (T - 1).bit_length())
    while K > 16 and (-T % K) * 8 > T:     # -T % K: the frames of padding
        K //= 2
    return K


def stash_bytes(B: int, T: int, H: int, *, n_dir: int = 1,
                stash_itemsize: int = 4, seq_chunk: int = 0) -> int:
    """Residual-stash bytes of the training forward (``repro.kernels.
    lstm_cell.stash_bytes``, ``:216``).  Unchunked: the post-activation
    gates (4H) and the cell state (H) per (row, step).  Chunked (a
    resolved K > 0): only the (h, c) chunk-entry carries, 2H per (row,
    chunk), ceil(T / K) chunks after time padding."""
    if seq_chunk and seq_chunk > 0:
        n_chunks = -(-T // seq_chunk)
        return n_dir * B * n_chunks * 2 * H * stash_itemsize
    return n_dir * B * T * 5 * H * stash_itemsize


def chunk_lengths(x, lengths):
    """The lengths of the chunked path, which is always masked: T for
    every row of a dense input, else ``lengths`` clipped to T, as int32
    of shape ``x.shape[:-2]`` (``lstm_cell.py:918-934``)."""
    T = x.shape[-2]
    if lengths is None:
        return torch.full(x.shape[:-2], T, dtype=torch.int32,
                          device=x.device)
    return torch.clamp(lengths.to(device=x.device, dtype=torch.int32),
                       max=T)


def _fwd_lib():
    lib = build.load("lstm_fwd")
    if lib.lstm_xproj.argtypes is None:
        lib.lstm_xproj.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.lstm_xproj.restype = _I
        lib.blstm_recur.argtypes = [_P] * 9 + [_I] * 11 + [_P]
        lib.blstm_recur.restype = _I
        lib.blstm_recur_active_clusters.argtypes = [_I, _I]
        lib.blstm_recur_active_clusters.restype = _I
    return lib


def _bwd_lib():
    lib = build.load("lstm_bwd")
    if lib.lstm_bwd_recur.argtypes is None:
        lib.lstm_bwd_recur.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.lstm_bwd_recur.restype = _I
        lib.lstm_bwd_dx.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.lstm_bwd_dx.restype = _I
        lib.lstm_bwd_dw.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.lstm_bwd_dw.restype = _I
    return lib


def _bwd_chunked_lib():
    lib = build.load("lstm_bwd_chunked")
    if lib.lstm_bwd_chunked.argtypes is None:
        lib.lstm_bwd_chunked.argtypes = [_P] * 23 + [_I] * 12 + [_P]
        lib.lstm_bwd_chunked.restype = _I
    return lib


def _stack_lib():
    lib = build.load("lstm_stack")
    if lib.lstm_stack.argtypes is None:
        arr = ctypes.POINTER(ctypes.c_void_p)
        lib.lstm_stack.argtypes = ([_P] + [arr] * 6 + [_P] * 6 + [_I] * 9
                                   + [_P])
        lib.lstm_stack.restype = _I
        lib.lstm_stack_active_clusters.argtypes = [_I, _I]
        lib.lstm_stack_active_clusters.restype = _I
    return lib


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")


def _launch(name, rc):
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# CTAs per cluster of the streaming recurrences (csrc/lstm_recur.cuh), each
# owning H / C hidden units, for the forward (K1's variants, K3's replay)
# and the reverse (K2, K3) alike; chosen by measurement at the training
# shape (PERF.md).
cluster_size = 2
MAX_UNITS = 256     # lstm_recur.cuh's MAX_CTA: units (threads) per CTA
# The resident forward recurrence: clusters of 16 CTAs (lstm_recur.cuh's
# RES_CLUSTER), each holding its slice of Wh in shared memory.  Where it
# runs, measured against the streaming launch at 16 learners on the H100
# (tools/ab_recurrence.py --stages, PERF.md §6): it wins over 1- and
# 2-row tiles from 4 steps on, over 4-row tiles from 16 (it loses at 4),
# and loses by ~2x over 8-row tiles at 21 to 256 steps.
RESIDENT_CLUSTER = 16
SMEM_LIMIT = 232448                  # shared memory of one CTA (bytes)
RESIDENT_MIN_STEPS = 16
RESIDENT_MAX_ROWS = 4


def block_rows(B: int) -> int:
    """Batch rows per tile of the recurrence kernels: up to 8 (a cluster
    reads Wh once a step for all its rows; 16-row tiles ran slower at the
    training shape, PERF.md)."""
    return next(bb for bb in (1, 2, 4, 8) if bb >= min(B, 8))


def recur_cluster(H: int, C: int) -> int:
    """The cluster size a streaming recurrence runs at width H: C, halved
    until H is a multiple of 4·C (a slice is whole float4s of the
    exchanged buffers); raises where no size leaves a CTA at most 256
    units."""
    while C > 1 and H % (4 * C):
        C //= 2
    if H // C > MAX_UNITS:
        raise ValueError(f"the recurrence kernels split H={H} over a "
                         f"cluster of CTAs of at most {MAX_UNITS} units: H "
                         f"above {MAX_UNITS} must be a multiple of 8")
    return C


def resident_smem(H: int, BB: int) -> int:
    """Shared memory of a resident forward CTA (lstm_recur.cuh's
    ``res_smem``): its slice of Wh (H/16 units × 4 gates × H inputs,
    bf16), h double-buffered in f32, two barriers and the tile's
    lengths."""
    return H * (H // RESIDENT_CLUSTER) * 8 + 2 * H * BB * 4 + 64


class RecurPlan(NamedTuple):
    """How one launch runs its forward recurrence: ``path`` "stream"
    (clusters of ``cluster`` CTAs reading Wh from device memory every
    step) or "resident" (clusters of 16 CTAs holding Wh
    in shared memory for the whole launch); tiles of ``block_rows`` rows.
    The reverse recurrence (K2, K3) always streams."""
    path: str
    block_rows: int
    cluster: int


def recur_plan(B: int, T: int, H: int) -> RecurPlan:
    """The forward recurrence launch of tiles of B rows over T steps (a
    chunked launch: its chunk's steps) at width H.  A launch of at least
    RESIDENT_MIN_STEPS steps over tiles of at most RESIDENT_MAX_ROWS rows
    runs resident: each step reads Wh from shared memory instead of
    device memory.  Other launches stream, at any H: a short one reads
    little of Wh, and an 8-row tile's step reads each weight once for 8
    rows while its resident product is 4x a 2-row one's.
    Raises ValueError where a resident launch is called for and H does
    not split into 16 slices that fit one CTA: it never falls back."""
    BB = block_rows(B)
    if T < RESIDENT_MIN_STEPS or BB > RESIDENT_MAX_ROWS:
        return RecurPlan("stream", BB, recur_cluster(H, cluster_size))
    smem = resident_smem(H, BB)
    if H % (4 * RESIDENT_CLUSTER) or smem > SMEM_LIMIT:
        raise ValueError(
            f"a recurrence of {T} steps runs resident on clusters of "
            f"{RESIDENT_CLUSTER} CTAs: H={H} must be a multiple of "
            f"{4 * RESIDENT_CLUSTER} whose slices ({H / RESIDENT_CLUSTER:g} "
            f"units, {smem} bytes of shared memory at {BB}-row tiles) fit "
            f"one CTA's {SMEM_LIMIT}")
    return RecurPlan("resident", BB, RESIDENT_CLUSTER)


def recur_waves(plan: RecurPlan, L: int, B: int, active: int,
                n_dir: int = 2) -> int:
    """Waves of clusters a resident launch of L learners' B rows in
    ``n_dir`` directions (2: the bidirectional layer, 1: ``lstm_sequence``)
    runs in when the card holds ``active`` of its clusters at once
    (:func:`active_clusters`): n_dir·L·ceil(B / block_rows) clusters."""
    return -(-n_dir * L * -(-B // plan.block_rows) // active)


def _plan_args(plan: RecurPlan, H: int) -> tuple:
    """(block_b, cluster, resident) of the C interface: ``cluster`` is the
    streaming cluster, which the reverse recurrence always runs on."""
    return (plan.block_rows, recur_cluster(H, cluster_size),
            int(plan.path == "resident"))


def _tile(B: int, H: int) -> tuple:
    """(rows per tile, cluster size) of a streaming recurrence launch."""
    return block_rows(B), recur_cluster(H, cluster_size)


def active_clusters(plan: RecurPlan, H: int) -> int:
    """How many clusters of the resident forward recurrence at ``plan``'s
    tile rows the card holds at once (cudaOccupancyMaxActiveClusters);
    negative: a CUDA error."""
    return _fwd_lib().blstm_recur_active_clusters(plan.block_rows, H)


def _launch_recur(name, rc, plan, H):
    """Raise on a failed launch of a forward recurrence; a resident one
    names its cluster size and how many such clusters the card holds."""
    if rc and plan.path == "resident":
        raise RuntimeError(
            f"{name} launch failed: cudaError {rc}; its clusters of "
            f"{RESIDENT_CLUSTER} CTAs: cudaOccupancyMaxActiveClusters "
            f"{active_clusters(plan, H)}")
    _launch(name, rc)


def _stacked(ws, x, lengths):
    """Add a learner axis of 1 to one model's tensors; returns (ws, x,
    lengths, squeeze) where ``squeeze`` drops it again."""
    if x.dim() == 4:
        return ws, x, lengths, lambda t: t
    ws = [w.unsqueeze(0) for w in ws]
    lengths = None if lengths is None else lengths.unsqueeze(0)
    return ws, x.unsqueeze(0), lengths, lambda t: t.squeeze(0)


def _check_weights(ws, L, D, H, dev, tag=""):
    for d, (wx, wh, b) in (("fwd", ws[:3]), ("bwd", ws[3:])):
        _check(f"{tag}{d}.wx", wx, (L, D, 4 * H), torch.bfloat16, dev)
        _check(f"{tag}{d}.wh", wh, (L, H, 4 * H), torch.bfloat16, dev)
        if b is not None:
            _check(f"{tag}{d}.b", b, (L, 4 * H), torch.float32, dev)
    if H > 512:
        raise ValueError(f"the stack kernel runs one thread per hidden "
                         f"unit in one CTA; H={H} > 512")


def _prepare(ws, x, lengths):
    """Check the stacked operands of one launch (biases may be None where
    the kernel takes none); returns (L, B, T, D, H, lengths as contiguous
    int32 (L, B))."""
    L, B, T, D = x.shape
    H = ws[1].shape[-2]
    dev = x.device
    _check("x", x, (L, B, T, D), torch.bfloat16, dev)
    _check_weights(ws, L, D, H, dev)
    if lengths is None:
        lens = torch.full((L, B), T, dtype=torch.int32, device=dev)
    else:
        lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
        _check("lengths", lens, (L, B), torch.int32, dev)
    return L, B, T, D, H, lens


def _fwd_layout(wh):
    """(L, H, 4H) -> (L, H, H, 4) gate-interleaved for the forward
    recurrence: unit j's 4 weights for input k adjacent."""
    L, H = wh.shape[0], wh.shape[1]
    return wh.view(L, H, 4, H).transpose(2, 3).contiguous()


def _res_fwd_layout(wh):
    """(L, H, 4H) -> (L, 16, H/2, U, 4, 2) for the resident forward, U =
    H/16: [l, c, k2, jj, q, e] = Wh[2·k2 + e, q·H + c·U + jj], CTA c's
    slice as it sits in its shared memory (one 4-byte word holds the
    weights of inputs 2·k2 and 2·k2 + 1 of one (unit, gate))."""
    L, H = wh.shape[0], wh.shape[1]
    C = RESIDENT_CLUSTER
    return wh.view(L, H // 2, 2, 4, C, H // C).permute(
        0, 4, 1, 5, 3, 2).contiguous()


def _recur_weights(wh, plan):
    """Wh in the layout ``plan``'s forward recurrence reads."""
    return _res_fwd_layout(wh) if plan.path == "resident" else _fwd_layout(wh)


def _bwd_layout(wh):
    """(L, H, 4H) -> (L, H, H, 4) for the reverse recurrence:
    W4[c4, j, q] = Wh[j, 4*c4 + q], so thread j reads the 4 weights of
    its row for 4 adjacent gate columns in one 8-byte load."""
    L, H = wh.shape[0], wh.shape[1]
    return wh.view(L, H, H, 4).transpose(1, 2).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _xproj(x, wxf, wxb, nd=2):
    """``lstm_xproj`` on the card: x (L, M, D) bf16 · wx_dir (L, D, N) bf16
    -> gx (L, nd, M, N) f32, the tensor-core GEMM of ``csrc/gemm.cuh``
    (nd = 1: ``wxf`` only)."""
    require_kernel_device(x)
    L, M, D = x.shape
    N = wxf.shape[-1]
    gx = torch.empty(L, nd, M, N, dtype=torch.float32, device=x.device)
    with on_card(x):
        _launch("lstm_xproj", _fwd_lib().lstm_xproj(
            x.data_ptr(), wxf.data_ptr(), wxb.data_ptr(), gx.data_ptr(), L,
            M, D,
            N, nd, _stream(x.device)))
    return gx


def _bwd_dx(dg, wxf, wxb, f32_out=False):
    """``lstm_bwd_dx`` on the card: dg (nd, L, M, N) f32 and wx_dir (L, D,
    N) bf16 -> dx (L, M, D), each direction's product rounded to bf16,
    summed in f32 and rounded again (nd = 1: the one product, rounded);
    with ``f32_out`` the f32 sum of the products, never rounded (the
    precision check's view)."""
    require_kernel_device(dg)
    nd, L, M, N = dg.shape
    D = wxf.shape[1]
    dx = torch.empty(L, M, D, device=dg.device,
                     dtype=torch.float32 if f32_out else torch.bfloat16)
    with on_card(dg):
        _launch("lstm_bwd_dx", _bwd_lib().lstm_bwd_dx(
            dg.data_ptr(), wxf.data_ptr(), wxb.data_ptr(), dx.data_ptr(), L, M,
            D, N, int(f32_out), nd, _stream(dg.device)))
    return dx


def _bwd_dw(x, y, dg, d0=0):
    """``lstm_bwd_dw`` on the card: x (L, B, T, D) bf16, y (L, B, T, nd·H)
    bf16, dg (nd, L, B*T, N) f32 -> dwx (nd, L, D, N) and dwhb (nd, L,
    H + 1, N) f32, row H of dwhb being db = Σ dgates; h_prev is y one
    recurrence step back (t - 1 forward, t + 1 reverse), zero at the
    boundary; nd = 1: direction ``d0`` alone."""
    require_kernel_device(x)
    L, B, T, D = x.shape
    nd, N = dg.shape[0], dg.shape[-1]
    H = y.shape[-1] // nd
    dwx = torch.empty(nd, L, D, N, dtype=torch.float32, device=x.device)
    dwhb = torch.empty(nd, L, H + 1, N, dtype=torch.float32, device=x.device)
    with on_card(x):
        _launch("lstm_bwd_dw", _bwd_lib().lstm_bwd_dw(
            x.data_ptr(), y.data_ptr(), dg.data_ptr(), dwx.data_ptr(),
            dwhb.data_ptr(), L, B, T, D, H, N, nd, d0, _stream(x.device)))
    return dwx, dwhb


def _dirs(reverse):
    """(nd, d0) of a launch: both directions (``reverse`` None), or the
    one direction, forward (False) or reversed (True)."""
    return (2, 0) if reverse is None else (1, int(bool(reverse)))


def _forward_kernel(ws, x, lengths, sdt, chunk=0, reverse=None):
    """K1 on the card: ``lstm_xproj`` (x·Wx, all learners and every
    direction of the launch) then ``blstm_recur`` (with the per-step stash
    when ``sdt``, or with ``chunk`` > 0 the chunk-entry carries in
    ``sdt``).  Returns (y, acts, cseq), or (y, hb, cb) when chunked.
    ``reverse`` None: both directions; else the one direction (its
    weights given twice in ``ws``), y (L, B, T, H) and stash (1, L, ...)."""
    require_kernel_device(x)
    L, B, T, D, H, lens = _prepare(ws, x, lengths)
    dev = x.device
    nd, d0 = _dirs(reverse)
    wxf, whf, bf, wxb, whb, bb = ws
    gx = _xproj(x.view(L, B * T, D), wxf, wxb, nd)
    y = torch.empty(L, B, T, nd * H, dtype=torch.bfloat16, device=dev)
    if chunk:                       # (h, c) entering each chunk
        n = -(-T // chunk)
        acts = torch.empty(nd, L, B, n, H, dtype=sdt, device=dev)
        cseq = torch.empty(nd, L, B, n, H, dtype=sdt, device=dev)
        kind = _ENTRY_KIND[sdt]
    elif sdt is not None:           # gates and c of every step
        acts = torch.empty(nd, L, B, T, 4 * H, dtype=sdt, device=dev)
        cseq = torch.empty(nd, L, B, T, H, dtype=sdt, device=dev)
        kind = _STASH_KIND[sdt]
    else:
        acts = cseq = None
        kind = 0
    # inference streams: K1's inference launch is the oracle K4 is held to
    # bit for bit, and no main path runs it (K4 runs its own plan)
    plan = recur_plan(B, T, H) if kind else RecurPlan(
        "stream", *_tile(B, H))
    whf4 = _recur_weights(whf, plan)
    whb4 = whf4 if whb is whf else _recur_weights(whb, plan)
    with on_card(x):
        _launch_recur("blstm_recur", _fwd_lib().blstm_recur(
            gx.data_ptr(), whf4.data_ptr(), whb4.data_ptr(), bf.data_ptr(),
            bb.data_ptr(), lens.data_ptr(), y.data_ptr(),
            acts.data_ptr() if acts is not None else None,
            cseq.data_ptr() if cseq is not None else None,
            kind, L, B, T, H, chunk, *_plan_args(plan, H), nd, d0,
            _stream(dev)),
            plan, H)
    return y, acts, cseq


def blstm_layer(wxf, whf, bf, wxb, whb, bb, x, lengths=None):
    """x (B, T, D) bf16 -> (B, T, 2H) bf16, forward direction in
    [..., :H], the time-reversed one in [..., H:]; or the same with a
    leading learner axis on every operand.

    Weights: wx (D, 4H) bf16, wh (H, 4H) bf16, b (4H,) f32 per direction,
    gate order i|f|g|o.  ``lengths`` (B,) int masks padded steps (carry
    frozen, output zeroed at t >= lengths[b])."""
    global launches
    if plain_path(x):
        return blstm_layer_ref(wxf, whf, bf, wxb, whb, bb, x, lengths)
    ws, xs, ls, squeeze = _stacked([wxf, whf, bf, wxb, whb, bb], x, lengths)
    y, _, _ = _forward_kernel(ws, xs, ls, None)
    launches += 1
    return squeeze(y)


MAX_STACK_LAYERS = 16    # lstm_stack.cu's MAX_LAYERS
# K4's x-projection tiles (two 128 x 128 x 16 bf16 tiles of gemm.cuh, two
# stages each: lstm_stack.cu's 2 * XTile::SMEM), which its resident CTAs
# keep beside their own regions
STACK_XPROJ_SMEM = 2 * 20992


def stack_smem(H: int, BB: int) -> int:
    """Shared memory of a resident CTA of K4 (lstm_stack.cu's
    ``res_stack_smem``): the resident forward's regions
    (:func:`resident_smem`) and the x-projection's two tiles."""
    return resident_smem(H, BB) + STACK_XPROJ_SMEM


def stack_resident(H: int) -> bool:
    """Whether K4's recurrences run resident at width H: H splits into 16
    slices of whole float4s (a multiple of 64) and a CTA's slice, h
    buffers and x-projection tiles fit its shared memory at
    RESIDENT_MAX_ROWS-row tiles."""
    return (H % (4 * RESIDENT_CLUSTER) == 0
            and stack_smem(H, RESIDENT_MAX_ROWS) <= SMEM_LIMIT)


class StackPlan(NamedTuple):
    """How K4 runs each layer's recurrences: ``path`` "resident" (one
    cluster of 16 CTAs an item, holding Wh in shared memory; ``clusters``
    items = 2·L·ceil(B / block_rows) in ``waves`` waves of what the card
    holds at once) or "item" (one 512-thread block an item, streaming Wh;
    no clusters, no waves)."""
    path: str
    block_rows: int
    clusters: int
    waves: int


def stack_plan(B: int, H: int, active: int, L: int = 1) -> StackPlan:
    """K4's plan for L learners' B rows at width H when the card holds
    ``active`` of its resident clusters at once
    (:func:`stack_active_clusters`).  Resident wherever H splits
    (:func:`stack_resident`): the fewest rows per tile (1, 2, 4) whose
    clusters fit one wave, else the fewest that leave no tile wider than
    B (at most 4 rows) in waves; a step's product
    grows with the rows (~2.0, 2.5 and 3.8 µs a step at 1-, 2- and 4-row
    tiles, 7.8 at 8-row ones, PERF.md §6), so a second wave costs more
    than wider tiles up to 4 rows.  Where H does not split, the item path
    at :func:`block_rows` rows: a rule by shape, never a reaction to a
    failed launch."""
    if not stack_resident(H):
        return StackPlan("item", block_rows(B), 0, 0)
    if active < 1:
        raise ValueError(f"K4's resident clusters of {RESIDENT_CLUSTER} "
                         f"CTAs at H={H} cannot be scheduled: "
                         f"cudaOccupancyMaxActiveClusters {active}")
    for rows in (1, 2, RESIDENT_MAX_ROWS):
        clusters = 2 * L * -(-B // rows)
        if clusters <= active or rows >= B:
            break
    return StackPlan("resident", rows, clusters, -(-clusters // active))


_STACK_ACTIVE: dict = {}


def stack_active_clusters(H: int) -> int:
    """How many resident clusters of K4 at width H the card holds at once
    (cudaOccupancyMaxActiveClusters at RESIDENT_MAX_ROWS-row tiles, whose
    shared memory is the largest the plan picks, so the count holds for
    every plan), queried once per H; negative: a CUDA error."""
    n = _STACK_ACTIVE.get(H)
    if n is None:
        n = _STACK_ACTIVE[H] = _stack_lib().lstm_stack_active_clusters(
            RESIDENT_MAX_ROWS, H)
    return n


def blstm_stack(layers, x, lengths=None):
    """The whole BLSTM stack, inference only: x (B, T, D0) bf16 ->
    (B, T, 2H) bf16, or the same with a leading learner axis on x, on
    every weight and on ``lengths``.  ``layers`` is a sequence of
    ``(wxf, whf, bf, wxb, whb, bb)`` as :func:`blstm_layer` takes them;
    layer 0 reads x, layer k > 0 the (.., 2H) output of layer k - 1.

    On a CUDA tensor one launch of K4 (``csrc/lstm_stack.cu``) runs every
    layer on :func:`stack_plan`'s path, bit-identical to the loop of
    :func:`blstm_layer` (the reference's contract for its fused stack,
    ``lstm_cell.py:1318-1320``); it never falls back to that loop or to
    another path.  On a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.blstm_stack_plain`."""
    global stack_launches
    if plain_path(x):
        return blstm_stack_plain(layers, x, lengths)
    require_kernel_device(x)
    layers = [list(ws) for ws in layers]
    if not 1 <= len(layers) <= MAX_STACK_LAYERS:
        raise ValueError(f"the stack kernel takes 1..{MAX_STACK_LAYERS} "
                         f"layers, got {len(layers)}")
    for k, ws in enumerate(layers):
        if ws[2] is None or ws[5] is None:
            raise ValueError(f"layer {k}: the stack kernel adds both "
                             f"directions' biases; got None")
    one = x.dim() == 3                  # one model: a learner axis of 1
    if one:
        layers = [[w.unsqueeze(0) for w in ws] for ws in layers]
        x = x.unsqueeze(0)
        lengths = None if lengths is None else lengths.unsqueeze(0)
    L, B, T, D0, H, lens = _prepare(layers[0], x, lengths)
    dev = x.device
    for k, ws in enumerate(layers[1:], 1):
        # layer k reads the (L, B, T, 2H) output of layer k - 1
        _check_weights(ws, L, 2 * H, H, dev, tag=f"layer {k} ")
    lib = _stack_lib()
    active = stack_active_clusters(H) if stack_resident(H) else 0
    plan = stack_plan(B, H, active, L)
    layout = _res_fwd_layout if plan.path == "resident" else _fwd_layout
    # every tensor whose pointer the launch takes is held in a local
    whf = [layout(ws[1]) for ws in layers]
    whb = [layout(ws[4]) for ws in layers]

    def ptrs(i, ts=None):
        ts = ts or [ws[i] for ws in layers]
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    gx = torch.empty(L, 2, B * T, 4 * H, dtype=torch.float32, device=dev)
    bufs = [torch.empty(L, B, T, 2 * H, dtype=torch.bfloat16, device=dev)
            for _ in range(min(len(layers) - 1, 2))]
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    y = torch.empty(L, B, T, 2 * H, dtype=torch.bfloat16, device=dev)
    buf_ptrs = [b.data_ptr() for b in bufs] + [None] * (2 - len(bufs))
    with on_card(x):
        _launch("lstm_stack", lib.lstm_stack(
            x.data_ptr(), ptrs(0), ptrs(3), ptrs(None, whf), ptrs(None, whb),
            ptrs(2), ptrs(5), lens.data_ptr(), gx.data_ptr(), *buf_ptrs,
            barrier.data_ptr(), y.data_ptr(), len(layers), L, B, T, D0, H,
            plan.block_rows, int(plan.path == "resident"), active,
            _stream(dev)))
    stack_launches += 1
    return y.squeeze(0) if one else y


def blstm_layer_train(wxf, whf, bf, wxb, whb, bb, x, lengths=None, *,
                      stash="float32", plain=False):
    """K1's stashing variant over stacked operands (x (L, B, T, D), ...):
    returns ``y`` (L, B, T, 2H) bf16, ``acts`` (2, L, B, T, 4H) and
    ``cseq`` (2, L, B, T, H) in the ``stash`` dtype, direction first.
    ``y`` is bit-identical to :func:`blstm_layer`'s."""
    global stash_launches
    sdt = stash_dtype(stash)
    if plain or plain_path(x):
        outs = [lstm_direction_train_ref(wx, wh, b, x, lengths,
                                         reverse=bool(d), stash=stash)
                for d, (wx, wh, b) in enumerate(((wxf, whf, bf),
                                                 (wxb, whb, bb)))]
        return (torch.cat([outs[0][0], outs[1][0]], dim=-1),
                torch.stack([outs[0][1], outs[1][1]]),
                torch.stack([outs[0][2], outs[1][2]]))
    out = _forward_kernel([wxf, whf, bf, wxb, whb, bb], x, lengths, sdt)
    stash_launches += 1
    return out


def blstm_layer_bwd(wxf, whf, wxb, whb, x, y, acts, cseq, dy, lengths=None,
                    *, need_dx=True, plain=False):
    """K2 for both directions against the stash of
    :func:`blstm_layer_train`: dy (L, B, T, 2H) -> (dx (L, B, T, D) in
    x's dtype or None, ((dwx, dwh, db) f32 per direction)).

    dx is each direction's dx rounded to x's dtype, summed in f32 and
    rounded again (``lstm_cell.py:949,1050``)."""
    global bwd_launches
    H = whf.shape[-2]
    if plain or plain_path(x):
        dxs, grads = [], []
        for d, (wx, wh) in enumerate(((wxf, whf), (wxb, whb))):
            sl = slice(d * H, (d + 1) * H)
            dxd, dwx, dwh, db = lstm_direction_bwd_ref(
                wx, wh, x, y[..., sl], acts[d], cseq[d], dy[..., sl],
                lengths, reverse=bool(d))
            dxs.append(dxd)
            grads.append((dwx, dwh, db))
        dx = (dxs[0].float() + dxs[1].float()).to(x.dtype) if need_dx \
            else None
        return dx, grads
    out = _bwd_kernel([wxf, whf, None, wxb, whb, None], x, y, acts, cseq, dy,
                      lengths, need_dx)
    bwd_launches += 1
    return out


def _bwd_kernel(ws, x, y, acts, cseq, dy, lengths, need_dx, reverse=None):
    """K2 on the card against the stash of :func:`_forward_kernel`:
    ``lstm_bwd_recur``, ``lstm_bwd_dx`` and ``lstm_bwd_dw`` over the
    launch's directions (``reverse`` as there).  Returns (dx or None,
    [(dwx, dwh, db) f32 per direction])."""
    require_kernel_device(x)
    L, B, T, D, H, lens = _prepare(ws, x, lengths)
    dev = x.device
    nd, d0 = _dirs(reverse)
    wxf, whf, _, wxb, whb, _ = ws
    sdt = acts.dtype
    _check("y", y, (L, B, T, nd * H), torch.bfloat16, dev)
    _check("dy", dy, (L, B, T, nd * H), torch.bfloat16, dev)
    _check("acts", acts, (nd, L, B, T, 4 * H), sdt, dev)
    _check("cseq", cseq, (nd, L, B, T, H), sdt, dev)
    if sdt not in _STASH_KIND:
        raise ValueError(f"stash dtype {sdt} is not one the kernel takes")
    whf4 = _bwd_layout(whf)
    whb4 = whf4 if whb is whf else _bwd_layout(whb)
    dg = torch.empty(nd, L, B * T, 4 * H, dtype=torch.float32, device=dev)
    with on_card(x):
        _launch("lstm_bwd_recur", _bwd_lib().lstm_bwd_recur(
            dy.data_ptr(), acts.data_ptr(), cseq.data_ptr(), whf4.data_ptr(),
            whb4.data_ptr(), lens.data_ptr(), dg.data_ptr(), _STASH_KIND[sdt],
            L, B, T, H, *_tile(B, H), nd, d0, _stream(dev)))
    dx = _bwd_dx(dg, wxf, wxb).view(L, B, T, D) if need_dx else None
    # rows 0..H-1 of dwhb: dWh = h_prev^T dgates; row H: db = 1^T dgates
    dwx, dwhb = _bwd_dw(x, y, dg, d0)
    # db is copied out so the (H + 1)-row buffer is freed once dWh is cast
    return dx, [(dwx[d], dwhb[d, :, :H], dwhb[d, :, H].contiguous())
                for d in range(nd)]


def blstm_layer_train_chunked(wxf, whf, bf, wxb, whb, bb, x, lengths=None,
                              *, chunk, stash="float32", plain=False):
    """K1's chunk-entry variant over stacked operands (x (L, B, T, D),
    ...), with ``chunk`` the resolved chunk length K (:func:`chunk_length`):
    returns ``y`` (L, B, T, 2H) bf16 and ``hb``, ``cb`` (2, L, B, n, H)
    in the ``stash`` dtype, n = ceil(T / K) — the (h, c) carry entering
    recurrence steps 0, K, 2K, ... of the padded time axis, direction
    first, in recurrence order.  No per-step stash is allocated.
    ``lengths`` (None: T for every row) masks as in
    :func:`blstm_layer_train`, whose ``y`` this is bit for bit."""
    global chunk_launches
    sdt = stash_dtype(stash)
    lens = chunk_lengths(x, lengths)
    if plain or plain_path(x):
        outs = [lstm_direction_chunk_fwd_ref(wx, wh, b, x, lens, chunk=chunk,
                                             reverse=bool(d), stash=stash)
                for d, (wx, wh, b) in enumerate(((wxf, whf, bf),
                                                 (wxb, whb, bb)))]
        return (torch.cat([outs[0][0], outs[1][0]], dim=-1),
                torch.stack([outs[0][1], outs[1][1]]),
                torch.stack([outs[0][2], outs[1][2]]))
    if chunk < 1:
        raise ValueError(f"chunk must be a resolved K > 0, got {chunk}")
    out = _forward_kernel([wxf, whf, bf, wxb, whb, bb], x, lens, sdt,
                          chunk=chunk)
    chunk_launches += 1
    return out


def blstm_layer_bwd_chunked(wxf, whf, bf, wxb, whb, bb, x, y, hb, cb, dy,
                            lengths=None, *, chunk, need_dx=True,
                            plain=False):
    """K3 for both directions against the entry carries of
    :func:`blstm_layer_train_chunked`: dy (L, B, T, 2H) -> (dx (L, B, T, D)
    in x's dtype or None, ((dwx, dwh, db) f32 per direction)), as
    :func:`blstm_layer_bwd` returns them.

    On the card one call runs the chunk loop of
    ``csrc/lstm_bwd_chunked.cu``; its scratch is chunk-sized (gx, gates
    and dgates (2, L, B, K, 4H) f32, c (2, L, B, K, H)), and h_{t-1} for
    dWh is read from ``y``."""
    global chunked_bwd_launches
    H = whf.shape[-2]
    lens = chunk_lengths(x, lengths)
    if plain or plain_path(x):
        dxs, grads = [], []
        for d, (wx, wh, b) in enumerate(((wxf, whf, bf), (wxb, whb, bb))):
            dxd, dwx, dwh, db = lstm_direction_bwd_chunked_ref(
                wx, wh, b, x, dy[..., d * H:(d + 1) * H], hb[d], cb[d],
                lens, chunk=chunk, reverse=bool(d))
            dxs.append(dxd)
            grads.append((dwx, dwh, db))
        dx = (dxs[0].float() + dxs[1].float()).to(x.dtype) if need_dx \
            else None
        return dx, grads
    out = _bwd_chunked_kernel([wxf, whf, bf, wxb, whb, bb], x, y, hb, cb, dy,
                              lens, chunk, need_dx)
    chunked_bwd_launches += 1
    return out


def _bwd_chunked_kernel(ws, x, y, hb, cb, dy, lens, chunk, need_dx,
                        reverse=None):
    """K3 on the card (``lstm_bwd_chunked``) over the launch's
    directions (``reverse`` as in :func:`_forward_kernel`).  Returns (dx or
    None, [(dwx, dwh, db) f32 per direction])."""
    require_kernel_device(x)
    L, B, T, D, H, lens = _prepare(ws, x, lens)
    dev = x.device
    nd, d0 = _dirs(reverse)
    wxf, whf, bf, wxb, whb, bb = ws
    if chunk < 1:
        raise ValueError(f"chunk must be a resolved K > 0, got {chunk}")
    n = -(-T // chunk)
    sdt = hb.dtype
    if sdt not in _STASH_KIND:
        raise ValueError(f"carry dtype {sdt} is not one the kernel takes")
    _check("y", y, (L, B, T, nd * H), torch.bfloat16, dev)
    _check("dy", dy, (L, B, T, nd * H), torch.bfloat16, dev)
    _check("hb", hb, (nd, L, B, n, H), sdt, dev)
    _check("cb", cb, (nd, L, B, n, H), sdt, dev)
    lib = _bwd_chunked_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    G = 4 * H
    gx = torch.empty(L, nd, B * chunk, G, **f32)
    acts = torch.empty(nd, L, B, chunk, G, **f32)
    cseq = torch.empty(nd, L, B, chunk, H, **f32)
    dg = torch.empty(nd, L, B, chunk, G, **f32)
    dh = torch.zeros(nd, L, B, H, **f32)
    dc = torch.zeros(nd, L, B, H, **f32)
    dx = (torch.zeros(L, B, T, D, dtype=x.dtype, device=dev) if need_dx
          else None)
    dwx = torch.zeros(nd, L, D, G, **f32)
    # rows 0..H-1: dWh = h_prev^T dgates; row H: db = 1^T dgates
    dwhb = torch.zeros(nd, L, H + 1, G, **f32)
    # held in locals: a temporary's block would go back to the allocator
    # as soon as its pointer is taken
    plan = recur_plan(B, chunk, H)
    whs = [_recur_weights(whf, plan), _bwd_layout(whf)]
    whs = ([whs[0], whs[0], whs[1], whs[1]] if whb is whf else
           [whs[0], _recur_weights(whb, plan), whs[1], _bwd_layout(whb)])
    with on_card(x):
        _launch_recur("lstm_bwd_chunked", lib.lstm_bwd_chunked(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), hb.data_ptr(),
            cb.data_ptr(), wxf.data_ptr(), wxb.data_ptr(),
            *(w.data_ptr() for w in whs),
            bf.data_ptr(), bb.data_ptr(), lens.data_ptr(), gx.data_ptr(),
            acts.data_ptr(), cseq.data_ptr(), dg.data_ptr(), dh.data_ptr(),
            dc.data_ptr(), dx.data_ptr() if dx is not None else None,
            dwx.data_ptr(), dwhb.data_ptr(), _STASH_KIND[sdt], L, B, T, D, H,
            chunk, *_plan_args(plan, H), nd, d0, _stream(dev)), plan, H)
    return dx, [(dwx[d], dwhb[d, :, :H], dwhb[d, :, H].contiguous())
                for d in range(nd)]


class _BlstmSequence(torch.autograd.Function):
    """The layer's VJP (``_blstm_vjp_fwd``/``_blstm_vjp_bwd``).  With
    ``chunk`` 0 the stashing forward saves y, acts and cseq and the
    backward runs K2; with a chunk length K the chunk-entry forward saves
    x, y, the lengths of the chunked path and the (h, c) entry carries
    (never a per-step stash) and the backward runs K3.  dWx, dWh are cast
    to the weight dtype, db stays f32."""

    @staticmethod
    def forward(ctx, wxf, whf, bf, wxb, whb, bb, x, lengths, stash, chunk,
                plain):
        ctx.plain, ctx.chunk = plain, chunk
        ctx.bias_dtypes = (bf.dtype, bb.dtype)
        if chunk:
            lens = chunk_lengths(x, lengths)
            y, hb, cb = blstm_layer_train_chunked(
                wxf, whf, bf, wxb, whb, bb, x, lens, chunk=chunk,
                stash=stash, plain=plain)
            ctx.save_for_backward(wxf, whf, bf, wxb, whb, bb, x, y, hb, cb,
                                  lens)
        else:
            y, acts, cseq = blstm_layer_train(wxf, whf, bf, wxb, whb, bb, x,
                                              lengths, stash=stash,
                                              plain=plain)
            ctx.save_for_backward(wxf, whf, wxb, whb, x, y, acts, cseq,
                                  lengths)
        return y

    @staticmethod
    def backward(ctx, dy):
        need_dx = ctx.needs_input_grad[6]
        if ctx.chunk:
            wxf, whf, bf, wxb, whb, bb, x, y, hb, cb, lens = ctx.saved_tensors
            dx, grads = blstm_layer_bwd_chunked(
                wxf, whf, bf, wxb, whb, bb, x, y, hb, cb, dy.contiguous(),
                lens, chunk=ctx.chunk, need_dx=need_dx, plain=ctx.plain)
        else:
            wxf, whf, wxb, whb, x, y, acts, cseq, lengths = ctx.saved_tensors
            dx, grads = blstm_layer_bwd(
                wxf, whf, wxb, whb, x, y, acts, cseq, dy.contiguous(),
                lengths, need_dx=need_dx, plain=ctx.plain)
        (dwxf, dwhf, dbf), (dwxb, dwhb, dbb) = grads
        return (dwxf.to(wxf.dtype), dwhf.to(whf.dtype),
                dbf.to(ctx.bias_dtypes[0]), dwxb.to(wxb.dtype),
                dwhb.to(whb.dtype), dbb.to(ctx.bias_dtypes[1]), dx,
                None, None, None, None)


def blstm_sequence(wxf, whf, bf, wxb, whb, bb, x, lengths=None, *,
                   stash_dtype=None, seq_chunk=0, plain=False):
    """Differentiable bidirectional layer over stacked operands: x
    (L, B, T, D) bf16 -> (L, B, T, 2H) bf16 (``repro.kernels.lstm_cell.
    blstm_sequence`` with a learner axis).  ``stash_dtype`` ('float32' |
    'bfloat16') sets the residual-stash precision; ``seq_chunk`` (K > 0
    frames, or -1 for auto, :func:`chunk_length`) selects the chunked
    pair, K1's chunk-entry variant and K3, whose stash is O(T/K);
    ``plain=True`` runs the plain versions on any device (the oracle)."""
    chunk = chunk_length(x.shape[-2], seq_chunk) if seq_chunk else 0
    return _BlstmSequence.apply(wxf, whf, bf, wxb, whb, bb, x, lengths,
                                stash_dtype or "float32", chunk, plain)


# ---------------------------------------------------------------------------
# One direction: the same kernels launched with nd = 1
# ---------------------------------------------------------------------------

def lstm_layer(wx, wh, b, x, lengths=None, *, reverse=False):
    """One LSTM direction, inference: x (B, T, D) bf16 -> (B, T, H) bf16,
    or the same with a leading learner axis on every operand; ``reverse``
    walks t = T-1..0 (within each row's valid span under ``lengths``).
    On a CUDA tensor one launch of K1 with one direction, bit-identical to
    that direction's half of :func:`blstm_layer`; on a CPU tensor
    :func:`~repro_torch.kernels.ref.lstm_direction_ref`."""
    global uni_launches
    if plain_path(x):
        return lstm_direction_ref(wx, wh, b, x, lengths, reverse=reverse)
    # the launches take one direction's weights in both slots
    ws, xs, ls, squeeze = _stacked([wx, wh, b] * 2, x, lengths)
    y, _, _ = _forward_kernel(ws, xs, ls, None, reverse=reverse)
    uni_launches += 1
    return squeeze(y)


def lstm_layer_train(wx, wh, b, x, lengths=None, *, reverse=False,
                     stash="float32", plain=False):
    """K1's stashing variant, one direction, over stacked operands (x (L,
    B, T, D), ...): ``y`` (L, B, T, H) bf16, ``acts`` (L, B, T, 4H) and
    ``cseq`` (L, B, T, H) in the ``stash`` dtype."""
    global uni_stash_launches
    if plain or plain_path(x):
        return lstm_direction_train_ref(wx, wh, b, x, lengths,
                                        reverse=reverse, stash=stash)
    y, acts, cseq = _forward_kernel([wx, wh, b] * 2, x, lengths,
                                    stash_dtype(stash), reverse=reverse)
    uni_stash_launches += 1
    return y, acts[0], cseq[0]


def lstm_layer_bwd(wx, wh, x, y, acts, cseq, dy, lengths=None, *,
                   reverse=False, need_dx=True, plain=False):
    """K2, one direction, against the stash of :func:`lstm_layer_train`:
    dy (L, B, T, H) -> (dx (L, B, T, D) in x's dtype or None, (dwx, dwh,
    db) f32), dx rounded once."""
    global uni_bwd_launches
    if plain or plain_path(x):
        dx, dwx, dwh, db = lstm_direction_bwd_ref(
            wx, wh, x, y, acts, cseq, dy, lengths, reverse=reverse)
        return (dx if need_dx else None), (dwx, dwh, db)
    dx, grads = _bwd_kernel([wx, wh, None] * 2, x, y, acts[None],
                            cseq[None], dy, lengths, need_dx,
                            reverse=reverse)
    uni_bwd_launches += 1
    return dx, grads[0]


def lstm_layer_train_chunked(wx, wh, b, x, lengths=None, *, chunk,
                             reverse=False, stash="float32", plain=False):
    """K1's chunk-entry variant, one direction (``chunk`` the resolved K):
    ``y`` (L, B, T, H) bf16 and ``hb``, ``cb`` (L, B, n, H) in the
    ``stash`` dtype, the carries entering each chunk in recurrence
    order."""
    global uni_chunk_launches
    lens = chunk_lengths(x, lengths)
    if plain or plain_path(x):
        return lstm_direction_chunk_fwd_ref(wx, wh, b, x, lens, chunk=chunk,
                                            reverse=reverse, stash=stash)
    if chunk < 1:
        raise ValueError(f"chunk must be a resolved K > 0, got {chunk}")
    y, hb, cb = _forward_kernel([wx, wh, b] * 2, x, lens, stash_dtype(stash),
                                chunk=chunk, reverse=reverse)
    uni_chunk_launches += 1
    return y, hb[0], cb[0]


def lstm_layer_bwd_chunked(wx, wh, b, x, y, hb, cb, dy, lengths=None, *,
                           chunk, reverse=False, need_dx=True, plain=False):
    """K3, one direction, against the carries of
    :func:`lstm_layer_train_chunked`: dy (L, B, T, H) -> (dx or None,
    (dwx, dwh, db) f32)."""
    global uni_chunked_bwd_launches
    lens = chunk_lengths(x, lengths)
    if plain or plain_path(x):
        dx, dwx, dwh, db = lstm_direction_bwd_chunked_ref(
            wx, wh, b, x, dy, hb, cb, lens, chunk=chunk, reverse=reverse)
        return (dx if need_dx else None), (dwx, dwh, db)
    dx, grads = _bwd_chunked_kernel([wx, wh, b] * 2, x, y, hb[None],
                                    cb[None], dy, lens, chunk, need_dx,
                                    reverse=reverse)
    uni_chunked_bwd_launches += 1
    return dx, grads[0]


class _LstmSequence(torch.autograd.Function):
    """One direction's VJP (``_lstm_vjp``, ``lstm_cell.py:954-988``), as
    :class:`_BlstmSequence` for both: the stashing pair (K1-stash + K2)
    or, with ``chunk`` K, the chunked pair (K1-chunk + K3)."""

    @staticmethod
    def forward(ctx, wx, wh, b, x, lengths, reverse, stash, chunk, plain):
        ctx.reverse, ctx.plain, ctx.chunk = reverse, plain, chunk
        ctx.bias_dtype = b.dtype
        if chunk:
            lens = chunk_lengths(x, lengths)
            y, hb, cb = lstm_layer_train_chunked(
                wx, wh, b, x, lens, chunk=chunk, reverse=reverse,
                stash=stash, plain=plain)
            ctx.save_for_backward(wx, wh, b, x, y, hb, cb, lens)
        else:
            y, acts, cseq = lstm_layer_train(wx, wh, b, x, lengths,
                                             reverse=reverse, stash=stash,
                                             plain=plain)
            ctx.save_for_backward(wx, wh, x, y, acts, cseq, lengths)
        return y

    @staticmethod
    def backward(ctx, dy):
        need_dx = ctx.needs_input_grad[3]
        if ctx.chunk:
            wx, wh, b, x, y, hb, cb, lens = ctx.saved_tensors
            dx, (dwx, dwh, db) = lstm_layer_bwd_chunked(
                wx, wh, b, x, y, hb, cb, dy.contiguous(), lens,
                chunk=ctx.chunk, reverse=ctx.reverse, need_dx=need_dx,
                plain=ctx.plain)
        else:
            wx, wh, x, y, acts, cseq, lengths = ctx.saved_tensors
            dx, (dwx, dwh, db) = lstm_layer_bwd(
                wx, wh, x, y, acts, cseq, dy.contiguous(), lengths,
                reverse=ctx.reverse, need_dx=need_dx, plain=ctx.plain)
        return (dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(ctx.bias_dtype),
                dx, None, None, None, None, None)


def lstm_sequence(wx, wh, b, x, lengths=None, *, reverse=False,
                  stash_dtype=None, seq_chunk=0, plain=False):
    """One differentiable LSTM direction (``repro.kernels.lstm_cell.
    lstm_sequence``): x (B, T, D) bf16 -> (B, T, H) bf16, or the same with
    a leading learner axis on every operand.  Without a gradient to take
    it is :func:`lstm_layer` (one K1 launch on the card); otherwise
    :class:`_LstmSequence` (K1-stash + K2, or with ``seq_chunk`` K1-chunk +
    K3).  ``stash_dtype`` and ``seq_chunk`` as :func:`blstm_sequence`'s;
    ``plain=True`` runs the plain versions on any device."""
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (wx, wh, b, x)):
        if plain:
            return lstm_direction_ref(wx, wh, b, x, lengths, reverse=reverse)
        return lstm_layer(wx, wh, b, x, lengths, reverse=reverse)
    one = x.dim() == 3
    if one:
        wx, wh, b, x = (t.unsqueeze(0) for t in (wx, wh, b, x))
        lengths = None if lengths is None else lengths.unsqueeze(0)
    chunk = chunk_length(x.shape[-2], seq_chunk) if seq_chunk else 0
    y = _LstmSequence.apply(wx, wh, b, x, lengths, bool(reverse),
                            stash_dtype or "float32", chunk, plain)
    return y.squeeze(0) if one else y
