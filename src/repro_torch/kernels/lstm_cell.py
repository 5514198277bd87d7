"""Fused bidirectional LSTM layer: the wrapper of the K1 port.

``blstm_layer`` is the counterpart of ``repro.kernels.lstm_cell``'s
inference forward (``_run_fwd`` with ``n_dir=2, stash=False``): on a
CUDA tensor it launches the two kernels of ``csrc/lstm_fwd.cu``
(``lstm_xproj``, then ``blstm_recur``) and counts one launch; on a CPU
tensor it runs the plain version, ``kernels.ref.blstm_layer_ref``.  It
never falls back from the card to the plain path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import blstm_layer_ref

launches = 0          # kernel launches (one per blstm_layer call on the card)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("lstm_fwd")
    if lib.lstm_xproj.argtypes is None:
        lib.lstm_xproj.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.lstm_xproj.restype = _I
        lib.blstm_recur.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _P]
        lib.blstm_recur.restype = _I
    return lib


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")


def block_rows(B: int) -> int:
    """Batch rows per CTA of ``blstm_recur`` (each CTA streams Wh once per
    step for all its rows, so a tile of up to 8 rows costs about one)."""
    return next(bb for bb in (1, 2, 4, 8) if bb >= min(B, 8))


def blstm_layer(wxf, whf, bf, wxb, whb, bb, x, lengths=None):
    """x (B, T, D) bf16 -> (B, T, 2H) bf16, forward direction in
    [..., :H], the time-reversed one in [..., H:].

    Weights: wx (D, 4H) bf16, wh (H, 4H) bf16, b (4H,) f32 per direction,
    gate order i|f|g|o.  ``lengths`` (B,) int masks padded steps (carry
    frozen, output zeroed at t >= lengths[b])."""
    global launches
    if x.device.type == "cpu":
        return blstm_layer_ref(wxf, whf, bf, wxb, whb, bb, x, lengths)
    require_kernel_device(x)
    B, T, D = x.shape
    H = whf.shape[0]
    dev = x.device
    _check("x", x, (B, T, D), torch.bfloat16, dev)
    for tag, (wx, wh, b) in (("fwd", (wxf, whf, bf)),
                             ("bwd", (wxb, whb, bb))):
        _check(f"{tag}.wx", wx, (D, 4 * H), torch.bfloat16, dev)
        _check(f"{tag}.wh", wh, (H, 4 * H), torch.bfloat16, dev)
        _check(f"{tag}.b", b, (4 * H,), torch.float32, dev)
    if H > 512:
        raise ValueError(f"blstm_recur runs one CTA of one thread per "
                         f"hidden unit; H={H} > 512")
    if lengths is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
        _check("lengths", lens, (B,), torch.int32, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gx = torch.empty(2, B * T, 4 * H, dtype=torch.float32, device=dev)
    rc = lib.lstm_xproj(x.data_ptr(), wxf.data_ptr(), wxb.data_ptr(),
                        gx.data_ptr(), B * T, D, 4 * H, stream)
    if rc:
        raise RuntimeError(f"lstm_xproj launch failed: cudaError {rc}")
    y = torch.empty(B, T, 2 * H, dtype=torch.bfloat16, device=dev)
    # gate-interleaved (H, H, 4): unit j's 4 weights for input k adjacent
    whf4, whb4 = (wh.view(H, 4, H).transpose(1, 2).contiguous()
                  for wh in (whf, whb))
    rc = lib.blstm_recur(gx.data_ptr(), whf4.data_ptr(), whb4.data_ptr(),
                         bf.data_ptr(), bb.data_ptr(), lens.data_ptr(),
                         y.data_ptr(), B, T, H, block_rows(B), stream)
    if rc:
        raise RuntimeError(f"blstm_recur launch failed: cudaError {rc}")
    launches += 1
    return y
