"""Fused bidirectional LSTM layer: the wrappers of the K1 and K2 ports.

* ``blstm_layer`` — the inference forward, counterpart of
  ``repro.kernels.lstm_cell._run_fwd`` with ``n_dir=2, stash=False``;
* ``blstm_layer_train`` — K1's stashing variant (``stash=True``), which
  also writes the post-activation gates and the cell states;
* ``blstm_layer_bwd`` — K2, ``_run_bwd`` for both directions;
* ``blstm_sequence`` — the differentiable layer, a
  ``torch.autograd.Function`` over the two, mirroring
  ``_blstm_vjp_fwd``/``_blstm_vjp_bwd`` (``lstm_cell.py:1026-1050``).

Every tensor may carry a leading learner axis (x (L, B, T, D), weights
(L, D, 4H), ..., lengths (L, B)): the learners are one more axis of each
kernel's grid, as ``jax.vmap`` of a ``pallas_call`` is.  On CUDA tensors
the wrappers launch the kernels of ``csrc/lstm_fwd.cu`` and
``csrc/lstm_bwd.cu`` and count their launches; on CPU tensors, or with
``plain=True`` (the oracle a check asks for by name), they run the plain
versions of ``kernels.ref``.  They never fall back from the card to the
plain path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import (blstm_layer_ref, lstm_direction_bwd_ref,
                                     lstm_direction_train_ref, stash_dtype)

launches = 0          # blstm_layer calls that launched the inference kernel
stash_launches = 0    # blstm_layer_train calls that launched the stash kernel
bwd_launches = 0      # blstm_layer_bwd calls that launched K2

_P = ctypes.c_void_p
_I = ctypes.c_int
_STASH_KIND = {torch.float32: 1, torch.bfloat16: 2}


def _fwd_lib():
    lib = build.load("lstm_fwd")
    if lib.lstm_xproj.argtypes is None:
        lib.lstm_xproj.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.lstm_xproj.restype = _I
        lib.blstm_recur.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.blstm_recur.restype = _I
    return lib


def _bwd_lib():
    lib = build.load("lstm_bwd")
    if lib.lstm_bwd_recur.argtypes is None:
        lib.lstm_bwd_recur.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        lib.lstm_bwd_recur.restype = _I
        lib.lstm_bwd_dx.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.lstm_bwd_dx.restype = _I
        lib.lstm_bwd_dw.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        lib.lstm_bwd_dw.restype = _I
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


def block_rows(B: int) -> int:
    """Batch rows per CTA of the recurrence kernels (each CTA streams Wh
    once per step for all its rows, so a tile of up to 8 rows costs about
    one)."""
    return next(bb for bb in (1, 2, 4, 8) if bb >= min(B, 8))


def _stacked(ws, x, lengths):
    """Add a learner axis of 1 to one model's tensors; returns (ws, x,
    lengths, squeeze) where ``squeeze`` drops it again."""
    if x.dim() == 4:
        return ws, x, lengths, lambda t: t
    ws = [w.unsqueeze(0) for w in ws]
    lengths = None if lengths is None else lengths.unsqueeze(0)
    return ws, x.unsqueeze(0), lengths, lambda t: t.squeeze(0)


def _prepare(ws, x, lengths):
    """Check the stacked operands of one launch (biases may be None where
    the kernel takes none); returns (L, B, T, D, H, lengths as contiguous
    int32 (L, B))."""
    L, B, T, D = x.shape
    H = ws[1].shape[-2]
    dev = x.device
    _check("x", x, (L, B, T, D), torch.bfloat16, dev)
    for tag, (wx, wh, b) in (("fwd", ws[:3]), ("bwd", ws[3:])):
        _check(f"{tag}.wx", wx, (L, D, 4 * H), torch.bfloat16, dev)
        _check(f"{tag}.wh", wh, (L, H, 4 * H), torch.bfloat16, dev)
        if b is not None:
            _check(f"{tag}.b", b, (L, 4 * H), torch.float32, dev)
    if H > 512:
        raise ValueError(f"the recurrence kernels run one thread per "
                         f"hidden unit in one CTA; H={H} > 512")
    if lengths is None:
        lens = torch.full((L, B), T, dtype=torch.int32, device=dev)
    else:
        lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
        _check("lengths", lens, (L, B), torch.int32, dev)
    return L, B, T, D, H, lens


def _forward_kernel(ws, x, lengths, sdt):
    """K1 on the card: ``lstm_xproj`` (x·Wx, all learners and both
    directions) then ``blstm_recur`` (with the stash when ``sdt``)."""
    require_kernel_device(x)
    L, B, T, D, H, lens = _prepare(ws, x, lengths)
    dev = x.device
    lib = _fwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    wxf, whf, bf, wxb, whb, bb = ws
    gx = torch.empty(L, 2, B * T, 4 * H, dtype=torch.float32, device=dev)
    _launch("lstm_xproj", lib.lstm_xproj(
        x.data_ptr(), wxf.data_ptr(), wxb.data_ptr(), gx.data_ptr(), L,
        B * T, D, 4 * H, stream))
    y = torch.empty(L, B, T, 2 * H, dtype=torch.bfloat16, device=dev)
    if sdt is None:
        acts = cseq = None
    else:
        acts = torch.empty(2, L, B, T, 4 * H, dtype=sdt, device=dev)
        cseq = torch.empty(2, L, B, T, H, dtype=sdt, device=dev)
    # gate-interleaved (L, H, H, 4): unit j's 4 weights for input k adjacent
    whf4, whb4 = (wh.view(L, H, 4, H).transpose(2, 3).contiguous()
                  for wh in (whf, whb))
    _launch("blstm_recur", lib.blstm_recur(
        gx.data_ptr(), whf4.data_ptr(), whb4.data_ptr(), bf.data_ptr(),
        bb.data_ptr(), lens.data_ptr(), y.data_ptr(),
        acts.data_ptr() if acts is not None else None,
        cseq.data_ptr() if cseq is not None else None,
        _STASH_KIND.get(sdt, 0), L, B, T, H, block_rows(B), stream))
    return y, acts, cseq


def blstm_layer(wxf, whf, bf, wxb, whb, bb, x, lengths=None):
    """x (B, T, D) bf16 -> (B, T, 2H) bf16, forward direction in
    [..., :H], the time-reversed one in [..., H:]; or the same with a
    leading learner axis on every operand.

    Weights: wx (D, 4H) bf16, wh (H, 4H) bf16, b (4H,) f32 per direction,
    gate order i|f|g|o.  ``lengths`` (B,) int masks padded steps (carry
    frozen, output zeroed at t >= lengths[b])."""
    global launches
    if x.device.type == "cpu":
        return blstm_layer_ref(wxf, whf, bf, wxb, whb, bb, x, lengths)
    ws, xs, ls, squeeze = _stacked([wxf, whf, bf, wxb, whb, bb], x, lengths)
    y, _, _ = _forward_kernel(ws, xs, ls, None)
    launches += 1
    return squeeze(y)


def blstm_layer_train(wxf, whf, bf, wxb, whb, bb, x, lengths=None, *,
                      stash="float32", plain=False):
    """K1's stashing variant over stacked operands (x (L, B, T, D), ...):
    returns ``y`` (L, B, T, 2H) bf16, ``acts`` (2, L, B, T, 4H) and
    ``cseq`` (2, L, B, T, H) in the ``stash`` dtype, direction first.
    ``y`` is bit-identical to :func:`blstm_layer`'s."""
    global stash_launches
    sdt = stash_dtype(stash)
    if plain or x.device.type == "cpu":
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
    if plain or x.device.type == "cpu":
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
    require_kernel_device(x)
    L, B, T, D, H, lens = _prepare([wxf, whf, None, wxb, whb, None], x,
                                   lengths)
    dev = x.device
    sdt = acts.dtype
    _check("y", y, (L, B, T, 2 * H), torch.bfloat16, dev)
    _check("dy", dy, (L, B, T, 2 * H), torch.bfloat16, dev)
    _check("acts", acts, (2, L, B, T, 4 * H), sdt, dev)
    _check("cseq", cseq, (2, L, B, T, H), sdt, dev)
    if sdt not in _STASH_KIND:
        raise ValueError(f"stash dtype {sdt} is not one the kernel takes")
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # (L, H, H, 4): W4[c4, j, q] = Wh[j, 4*c4 + q], so thread j reads the
    # 4 weights of its row for 4 adjacent gate columns in one 8-byte load
    whf4, whb4 = (wh.view(L, H, H, 4).transpose(1, 2).contiguous()
                  for wh in (whf, whb))
    dg = torch.empty(2, L, B, T, 4 * H, dtype=torch.float32, device=dev)
    _launch("lstm_bwd_recur", lib.lstm_bwd_recur(
        dy.data_ptr(), acts.data_ptr(), cseq.data_ptr(), whf4.data_ptr(),
        whb4.data_ptr(), lens.data_ptr(), dg.data_ptr(), _STASH_KIND[sdt],
        L, B, T, H, block_rows(B), stream))
    dx = None
    if need_dx:
        dx = torch.empty(L, B, T, D, dtype=x.dtype, device=dev)
        _launch("lstm_bwd_dx", lib.lstm_bwd_dx(
            dg.data_ptr(), wxf.data_ptr(), wxb.data_ptr(), dx.data_ptr(),
            L, B * T, D, 4 * H, stream))
    dwx = torch.empty(2, L, D, 4 * H, dtype=torch.float32, device=dev)
    # rows 0..H-1: dWh = h_prev^T dgates; row H: db = 1^T dgates
    dwhb = torch.empty(2, L, H + 1, 4 * H, dtype=torch.float32, device=dev)
    _launch("lstm_bwd_dw", lib.lstm_bwd_dw(
        x.data_ptr(), y.data_ptr(), dg.data_ptr(), dwx.data_ptr(),
        dwhb.data_ptr(), L, B, T, D, H, 4 * H, stream))
    bwd_launches += 1
    # db is copied out so the (H + 1)-row buffer is freed once dWh is cast
    return dx, [(dwx[d], dwhb[d, :, :H], dwhb[d, :, H].contiguous())
                for d in range(2)]


class _BlstmSequence(torch.autograd.Function):
    """The layer's VJP (``_blstm_vjp_fwd``/``_blstm_vjp_bwd``): the
    stashing forward saves y, acts and cseq; the backward runs K2 and
    casts dWx, dWh to the weight dtype, db staying f32."""

    @staticmethod
    def forward(ctx, wxf, whf, bf, wxb, whb, bb, x, lengths, stash, plain):
        y, acts, cseq = blstm_layer_train(wxf, whf, bf, wxb, whb, bb, x,
                                          lengths, stash=stash, plain=plain)
        ctx.save_for_backward(wxf, whf, wxb, whb, x, y, acts, cseq, lengths)
        ctx.plain = plain
        ctx.bias_dtypes = (bf.dtype, bb.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        wxf, whf, wxb, whb, x, y, acts, cseq, lengths = ctx.saved_tensors
        dx, grads = blstm_layer_bwd(
            wxf, whf, wxb, whb, x, y, acts, cseq, dy.contiguous(), lengths,
            need_dx=ctx.needs_input_grad[6], plain=ctx.plain)
        (dwxf, dwhf, dbf), (dwxb, dwhb, dbb) = grads
        return (dwxf.to(wxf.dtype), dwhf.to(whf.dtype),
                dbf.to(ctx.bias_dtypes[0]), dwxb.to(wxb.dtype),
                dwhb.to(whb.dtype), dbb.to(ctx.bias_dtypes[1]), dx,
                None, None, None)


def blstm_sequence(wxf, whf, bf, wxb, whb, bb, x, lengths=None, *,
                   stash_dtype=None, seq_chunk=0, plain=False):
    """Differentiable bidirectional layer over stacked operands: x
    (L, B, T, D) bf16 -> (L, B, T, 2H) bf16 (``repro.kernels.lstm_cell.
    blstm_sequence`` with a learner axis).  ``stash_dtype`` ('float32' |
    'bfloat16') sets the residual-stash precision; ``plain=True`` runs
    the plain versions on any device (the oracle)."""
    if seq_chunk:
        raise NotImplementedError(
            "seq_chunk != 0 (the chunked-recompute backward K3 and K1's "
            "chunk-entry variant) is not ported yet: ROADMAP.md queue 1, "
            "item 1")
    return _BlstmSequence.apply(wxf, whf, bf, wxb, whb, bb, x, lengths,
                                stash_dtype or "float32", plain)
