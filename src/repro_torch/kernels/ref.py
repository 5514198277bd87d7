"""Plain PyTorch versions of the kernels in this package.

Written for clarity and exactness, not speed: the CPU path of every
kernel wrapper, and the oracle that ``chip_smoke.py`` and the GPU tests
hold the CUDA kernels against.
"""
from __future__ import annotations

import torch


def lstm_direction_ref(wx, wh, b, x, lengths=None, *, reverse=False):
    """One LSTM direction, x (B, T, D) bf16 -> (B, T, H) bf16.

    Mirrors ``repro.kernels.lstm_cell._cell_math`` and the masking of the
    K1 kernel body: gate order i|f|g|o, forget bias +1 inside the
    sigmoid, f32 accumulation of both products, the recurrent h rounded
    to bf16 before it multiplies ``wh``, (h, c) carried in f32.  With
    ``lengths`` (B,) the carry is frozen and the output zeroed at
    t >= lengths[b]; the reverse direction walks t = T-1-s over the
    padded T, so it reverses within each row's valid span."""
    B, T, _ = x.shape
    H = wh.shape[0]
    gx = x.float() @ wx.float()                       # (B, T, 4H) f32
    whf = wh.float()
    bf = b.float()
    h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    c = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    y = torch.empty(B, T, H, dtype=torch.bfloat16, device=x.device)
    for s in range(T):
        t = T - 1 - s if reverse else s
        hx = h.to(torch.bfloat16).float()
        gates = gx[:, t] + hx @ whf + bf
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H] + 1.0)
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if lengths is None:
            c, h, out = c_new, h_new, h_new
        else:
            v = (t < lengths)[:, None]
            c = torch.where(v, c_new, c)                  # freeze carry
            out = torch.where(v, h_new, torch.zeros_like(h_new))
            h = torch.where(v, h_new, h)
        y[:, t] = out.to(torch.bfloat16)
    return y


def blstm_layer_ref(wxf, whf, bf, wxb, whb, bb, x, lengths=None):
    """Bidirectional layer: forward direction in [..., :H], the
    time-reversed one in [..., H:] (``repro.kernels.ref.blstm_ref``)."""
    return torch.cat(
        [lstm_direction_ref(wxf, whf, bf, x, lengths),
         lstm_direction_ref(wxb, whb, bb, x, lengths, reverse=True)],
        dim=-1)
