"""Plain PyTorch versions of the kernels in this package.

Written for clarity and exactness, not speed: the CPU path of every
kernel wrapper, and the oracle that ``chip_smoke.py`` and the GPU tests
hold the CUDA kernels against.

The LSTM functions take either one model's tensors — x (B, T, D),
wx (D, 4H), wh (H, 4H), b (4H,), lengths (B,) — or a stack of learners
with one more leading axis on every one of them: x (L, B, T, D),
wx (L, D, 4H), ..., lengths (L, B).
"""
from __future__ import annotations

import torch

_STASH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stash_dtype(name) -> torch.dtype:
    """The residual-stash dtype named by ``lstm_stash_dtype`` (None ->
    float32)."""
    try:
        return _STASH[name or "float32"]
    except KeyError:
        raise ValueError(f"stash dtype {name!r}: expected one of "
                         f"{sorted(_STASH)}") from None


def _per_time(w):
    """A (L, D, N) stacked weight broadcast against (L, B, T, D)."""
    return w if w.dim() == 2 else w.unsqueeze(-3)


def _per_row(v):
    """A (L, N) stacked bias broadcast against (L, B, N)."""
    return v if v.dim() == 1 else v.unsqueeze(-2)


def _steps(T: int, reverse: bool):
    """Real time index of each recurrence step s = 0..T-1."""
    return range(T - 1, -1, -1) if reverse else range(T)


def lstm_direction_train_ref(wx, wh, b, x, lengths=None, *, reverse=False,
                             stash="float32"):
    """One LSTM direction with the training stash: returns ``y`` (B, T, H)
    bf16, ``acts`` (B, T, 4H) and ``cseq`` (B, T, H) in the ``stash``
    dtype.

    Mirrors ``repro.kernels.lstm_cell._cell_math`` and the stashing body
    of ``_make_fwd_kernel`` (``lstm_cell.py:405-424``): gate order
    i|f|g|o, forget bias +1 inside the sigmoid, f32 accumulation of both
    products, the recurrent h rounded to bf16 before it multiplies
    ``wh``, (h, c) carried in f32.  ``acts`` are the post-activation
    gates as computed (not masked); ``cseq`` is the carry after the
    freeze.  With ``lengths`` the carry is frozen and the output zeroed
    at t >= lengths; the reverse direction walks t = T-1-s over the
    padded T, so it reverses within each row's valid span."""
    sdt = stash_dtype(stash)
    T = x.shape[-2]
    H = wh.shape[-2]
    gx = x.float() @ _per_time(wx).float()            # (..., B, T, 4H) f32
    whf = wh.float()
    bf = _per_row(b).float()
    lead = x.shape[:-2]                                # (..., B)
    h = torch.zeros(*lead, H, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    y = torch.empty(*lead, T, H, dtype=torch.bfloat16, device=x.device)
    acts = torch.empty(*lead, T, 4 * H, dtype=sdt, device=x.device)
    cseq = torch.empty(*lead, T, H, dtype=sdt, device=x.device)
    for t in _steps(T, reverse):
        hx = h.to(torch.bfloat16).float()
        gates = gx[..., t, :] + hx @ whf + bf
        i = torch.sigmoid(gates[..., 0 * H:1 * H])
        f = torch.sigmoid(gates[..., 1 * H:2 * H] + 1.0)
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:4 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if lengths is None:
            c, h, out = c_new, h_new, h_new
        else:
            v = (t < lengths)[..., None]
            c = torch.where(v, c_new, c)                  # freeze carry
            out = torch.where(v, h_new, torch.zeros_like(h_new))
            h = torch.where(v, h_new, h)
        y[..., t, :] = out.to(torch.bfloat16)
        acts[..., t, :] = torch.cat([i, f, g, o], dim=-1).to(sdt)
        cseq[..., t, :] = c.to(sdt)
    return y, acts, cseq


def lstm_direction_ref(wx, wh, b, x, lengths=None, *, reverse=False):
    """One LSTM direction, x (B, T, D) bf16 -> (B, T, H) bf16: the
    inference forward, :func:`lstm_direction_train_ref` without its
    stash."""
    return lstm_direction_train_ref(wx, wh, b, x, lengths,
                                    reverse=reverse)[0]


def blstm_layer_ref(wxf, whf, bf, wxb, whb, bb, x, lengths=None):
    """Bidirectional layer: forward direction in [..., :H], the
    time-reversed one in [..., H:] (``repro.kernels.ref.blstm_ref``)."""
    return torch.cat(
        [lstm_direction_ref(wxf, whf, bf, x, lengths),
         lstm_direction_ref(wxb, whb, bb, x, lengths, reverse=True)],
        dim=-1)


def lstm_direction_bwd_ref(wx, wh, x, y, acts, cseq, dy, lengths=None, *,
                           reverse=False):
    """The plain K2: one direction's backward against the stash of
    :func:`lstm_direction_train_ref`.  Returns dx (rounded to x's
    dtype), dWx, dWh and db, all three in f32.

    Mirrors ``_make_bwd_kernel`` (``lstm_cell.py:516-609``): the
    recurrence runs in reverse (the forward direction walks t = T-1..0,
    the reverse direction t = 0..T-1, ``_bwd_tmap``), carrying (dh, dc)
    in f32.  h_{t-1} is the stashed ``y`` and c_{t-1} the stashed
    ``cseq`` at the previous recurrence step, both zero at the boundary
    (``_bwd_pmap``).  With ``lengths``, dh and dc are zeroed on padded
    steps (so their dgates are zero) and the (dh, dc) carries pass
    through them.  ``wx`` and ``wh`` are upcast to f32.  The products
    with x, h_{t-1} and wx do not feed the recurrence, so they are taken
    once over all steps after the loop — the same sums as the kernel's
    per-step accumulation."""
    T = x.shape[-2]
    H = wh.shape[-2]
    whf = wh.float()
    lead = x.shape[:-2]
    zero = torch.zeros(*lead, H, dtype=torch.float32, device=x.device)
    dh_c, dc_c = zero, zero
    dgates = torch.empty(*lead, T, 4 * H, dtype=torch.float32,
                         device=x.device)
    hprev = torch.zeros(*lead, T, H, dtype=torch.float32, device=x.device)
    order = list(_steps(T, reverse))                  # forward recurrence
    for s in range(T - 1, -1, -1):                    # ... walked backwards
        t = order[s]
        a = acts[..., t, :].float()
        i, f, g, o = (a[..., k * H:(k + 1) * H] for k in range(4))
        c = cseq[..., t, :].float()
        if s == 0:
            c_prev = zero
        else:
            c_prev = cseq[..., order[s - 1], :].float()
            hprev[..., t, :] = y[..., order[s - 1], :].float()
        dh = dy[..., t, :].float() + dh_c
        tc = torch.tanh(c)
        dc = dh * o * (1.0 - tc * tc) + dc_c
        if lengths is not None:
            v = (t < lengths)[..., None]
            dh = torch.where(v, dh, zero)
            dc = torch.where(v, dc, zero)
        dg = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        dh * tc * o * (1.0 - o)], dim=-1)
        dgates[..., t, :] = dg
        dh_new = dg @ whf.transpose(-1, -2)
        dc_new = dc * f
        if lengths is not None:
            dh_new = torch.where(v, dh_new, dh_c)
            dc_new = torch.where(v, dc_new, dc_c)
        dh_c, dc_c = dh_new, dc_new
    dx = (dgates @ _per_time(wx).float().transpose(-1, -2)).to(x.dtype)
    rows = dgates.flatten(-3, -2)                     # (..., B*T, 4H)
    dwx = x.float().flatten(-3, -2).transpose(-1, -2) @ rows
    dwh = hprev.flatten(-3, -2).transpose(-1, -2) @ rows
    db = rows.sum(-2)
    return dx, dwx, dwh, db
