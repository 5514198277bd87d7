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


def _rows_matmul(x, w):
    """x (..., T, D) @ w (D, N); or, for a stacked weight w (L, D, N) and
    x (L, B, T, D), one product over each learner's B·T rows.  A
    learner's rows so give the same bits whatever the number of learners
    in the stack: a broadcast product folds a lone learner's rows into
    one matrix, which rounds otherwise than a stack's per-row
    products."""
    if w.dim() == 2:
        return x @ w
    return torch.bmm(x.reshape(w.shape[0], -1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


def _per_row(v):
    """A (L, N) stacked bias broadcast against (L, B, N)."""
    return v if v.dim() == 1 else v.unsqueeze(-2)


def _steps(T: int, reverse: bool):
    """Real time index of each recurrence step s = 0..T-1."""
    return range(T - 1, -1, -1) if reverse else range(T)


def _cell(gx_t, h, c, whf, bf):
    """One LSTM cell step (``_cell_math``): gate order i|f|g|o, forget
    bias +1, the recurrent h rounded to bf16 before the product, f32
    throughout.  Returns (i, f, g, o, c_new, h_new)."""
    H = whf.shape[-2]
    hx = h.to(torch.bfloat16).float()
    gates = gx_t + hx @ whf + bf
    i = torch.sigmoid(gates[..., 0 * H:1 * H])
    f = torch.sigmoid(gates[..., 1 * H:2 * H] + 1.0)
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = torch.sigmoid(gates[..., 3 * H:4 * H])
    c_new = f * c + i * g
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def _pad_time(a, Tp: int):
    """Zero-pad axis -2 (time) of ``a`` to ``Tp`` steps."""
    T = a.shape[-2]
    if T == Tp:
        return a
    pad = a.new_zeros(*a.shape[:-2], Tp - T, a.shape[-1])
    return torch.cat([a, pad], dim=-2)


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
    gx = _rows_matmul(x.float(), wx.float())          # (..., B, T, 4H) f32
    whf = wh.float()
    bf = _per_row(b).float()
    lead = x.shape[:-2]                                # (..., B)
    h = torch.zeros(*lead, H, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    y = torch.empty(*lead, T, H, dtype=torch.bfloat16, device=x.device)
    acts = torch.empty(*lead, T, 4 * H, dtype=sdt, device=x.device)
    cseq = torch.empty(*lead, T, H, dtype=sdt, device=x.device)
    for t in _steps(T, reverse):
        i, f, g, o, c_new, h_new = _cell(gx[..., t, :], h, c, whf, bf)
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


def blstm_stack_plain(layers, x, lengths=None):
    """The plain fused stack (K4's plain version): the per-layer loop of
    :func:`blstm_layer_ref`, each layer consuming the previous layer's
    (..., T, 2H) output (``repro.kernels.ref.blstm_stack_ref``).
    ``layers`` is a sequence of ``(wxf, whf, bf, wxb, whb, bb)``."""
    for ws in layers:
        x = blstm_layer_ref(*ws, x, lengths)
    return x


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
    dx = _rows_matmul(dgates, wx.float().transpose(-1, -2)).to(
        x.dtype)
    rows = dgates.flatten(-3, -2)                     # (..., B*T, 4H)
    dwx = x.float().flatten(-3, -2).transpose(-1, -2) @ rows
    dwh = hprev.flatten(-3, -2).transpose(-1, -2) @ rows
    db = rows.sum(-2)
    return dx, dwx, dwh, db


def lstm_direction_chunk_fwd_ref(wx, wh, b, x, lengths, *, chunk,
                                 reverse=False, stash="float32"):
    """One LSTM direction with the chunk-entry stash of
    ``_make_fwd_kernel(chunk=K)`` (``lstm_cell.py:394-404``): returns
    ``y`` (B, T, H) bf16 and ``hb``, ``cb`` (B, n, H) in the ``stash``
    dtype, n = ceil(T / K): the (h, c) carry entering recurrence step
    r·K, in recurrence order (the reverse direction's chunk 0 holds its
    first steps, the last frames).

    x is zero-padded to T_pad = n·K frames and the masked recurrence runs
    over all of them, as the reference's chunked path does; ``lengths``
    (never None here: the caller synthesizes T for dense input) is at
    most T, so the padded frames are masked steps and ``y`` is
    :func:`lstm_direction_train_ref`'s."""
    sdt = stash_dtype(stash)
    T = x.shape[-2]
    H = wh.shape[-2]
    K = chunk
    n = -(-T // K)
    Tp = n * K
    gx = _rows_matmul(_pad_time(x, Tp).float(), wx.float())
    whf = wh.float()
    bf = _per_row(b).float()
    lead = x.shape[:-2]
    h = torch.zeros(*lead, H, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    y = torch.zeros(*lead, Tp, H, dtype=torch.bfloat16, device=x.device)
    hb = torch.empty(*lead, n, H, dtype=sdt, device=x.device)
    cb = torch.empty(*lead, n, H, dtype=sdt, device=x.device)
    for s, t in enumerate(_steps(Tp, reverse)):
        if s % K == 0:
            hb[..., s // K, :] = h.to(sdt)
            cb[..., s // K, :] = c.to(sdt)
        i, f, g, o, c_new, h_new = _cell(gx[..., t, :], h, c, whf, bf)
        v = (t < lengths)[..., None]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        y[..., t, :] = torch.where(v, h_new, torch.zeros_like(h_new)).to(
            torch.bfloat16)
    return y[..., :T, :], hb, cb


def lstm_direction_bwd_chunked_ref(wx, wh, b, x, dy, hb, cb, lengths, *,
                                   chunk, reverse=False):
    """The plain K3: one direction's chunked-recompute backward against
    the entry carries of :func:`lstm_direction_chunk_fwd_ref`.  Returns
    dx (rounded to x's dtype), dWx, dWh and db in f32.

    Mirrors ``_make_bwd_chunked_kernel`` (``lstm_cell.py:684-801``): the
    recurrence chunks are visited in reverse (chunk n-1 first, in both
    directions); each one replays the forward from its entry carry,
    rebuilding the gates, c_{t-1} and the bf16-rounded h_{t-1} of its K
    steps, then runs :func:`lstm_direction_bwd_ref`'s reverse steps
    against them with (dh, dc) carried in from the later chunk.  The
    chunk's dx, x^T·dgates, h_prev^T·dgates and Σ dgates are taken once
    per chunk and the weight gradients summed over chunks in f32.  Only
    chunk-sized buffers live across a chunk; the forward direction's
    recurrence chunk r covers frames [rK, (r+1)K) of the padded time
    axis, the reverse direction's [T_pad-(r+1)K, T_pad-rK)."""
    T = x.shape[-2]
    H = wh.shape[-2]
    K = chunk
    n = hb.shape[-2]
    Tp = n * K
    if n != -(-T // K):
        raise ValueError(f"{n} entry carries for T={T}, K={K}")
    xp = _pad_time(x, Tp)
    dyp = _pad_time(dy, Tp)
    wxf = wx.float()
    whf = wh.float()
    bf = _per_row(b).float()
    lead = x.shape[:-2]
    zero = torch.zeros(*lead, H, dtype=torch.float32, device=x.device)
    dh_c, dc_c = zero, zero
    dwx = torch.zeros(wx.shape, dtype=torch.float32, device=x.device)
    dwh = torch.zeros(wh.shape, dtype=torch.float32, device=x.device)
    db = torch.zeros(b.shape, dtype=torch.float32, device=x.device)
    dx = torch.empty(*lead, Tp, x.shape[-1], dtype=x.dtype, device=x.device)
    order = list(_steps(Tp, reverse))
    for r in range(n - 1, -1, -1):
        times = order[r * K:(r + 1) * K]          # recurrence order
        lo = min(times)                            # the chunk's frames
        xc = xp[..., lo:lo + K, :].float()
        gx = _rows_matmul(xc, wxf)
        acts = torch.empty(*lead, K, 4 * H, dtype=torch.float32,
                           device=x.device)
        c_after = torch.empty(*lead, K, H, dtype=torch.float32,
                              device=x.device)
        c_prev = torch.empty_like(c_after)
        h_prev = torch.empty_like(c_after)
        h = hb[..., r, :].float()
        c = cb[..., r, :].float()
        for t in times:                            # phase 1: replay
            k = t - lo
            h_prev[..., k, :] = h.to(torch.bfloat16).float()
            c_prev[..., k, :] = c
            i, f, g, o, c_new, h_new = _cell(gx[..., k, :], h, c, whf, bf)
            v = (t < lengths)[..., None]
            c = torch.where(v, c_new, c)
            h = torch.where(v, h_new, h)
            acts[..., k, :] = torch.cat([i, f, g, o], dim=-1)
            c_after[..., k, :] = c
        dg = torch.empty_like(acts)
        for t in reversed(times):                  # phase 2: reverse steps
            k = t - lo
            i, f, g, o = (acts[..., k, q * H:(q + 1) * H] for q in range(4))
            cp = c_prev[..., k, :]
            dh = dyp[..., t, :].float() + dh_c
            tc = torch.tanh(c_after[..., k, :])
            dc = dh * o * (1.0 - tc * tc) + dc_c
            v = (t < lengths)[..., None]
            dh = torch.where(v, dh, zero)
            dc = torch.where(v, dc, zero)
            dgk = torch.cat([dc * g * i * (1.0 - i),
                             dc * cp * f * (1.0 - f),
                             dc * i * (1.0 - g * g),
                             dh * tc * o * (1.0 - o)], dim=-1)
            dg[..., k, :] = dgk
            dh_c = torch.where(v, dgk @ whf.transpose(-1, -2), dh_c)
            dc_c = torch.where(v, dc * f, dc_c)
        dx[..., lo:lo + K, :] = _rows_matmul(
            dg, wxf.transpose(-1, -2)).to(x.dtype)
        rows = dg.flatten(-3, -2)                  # (..., B*K, 4H)
        dwx += xc.flatten(-3, -2).transpose(-1, -2) @ rows
        dwh += h_prev.flatten(-3, -2).transpose(-1, -2) @ rows
        db += rows.sum(-2)
    return dx[..., :T, :], dwx, dwh, db


# ---------------------------------------------------------------------------
# SSD (mamba-2 state-space duality)
# ---------------------------------------------------------------------------

def expand_groups(a, H: int):
    """B/C per group (..., G, N) -> per head (..., H, N): head h reads
    group h // (H // G), the reference's ``jnp.repeat`` over the group
    axis."""
    G = a.shape[-2]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} B/C groups")
    return a if G == H else a.repeat_interleave(H // G, dim=-2)


def ssd_ref(x, dt, A, Bm, Cm):
    """Exact token-by-token SSM recurrence (``repro.kernels.ref.ssd_ref``).

    x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, G, N) with G
    dividing H.  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T; y_t = C_t . h_t.
    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, N, P) f32)."""
    Bsz, S, H, P = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf = expand_groups(Bm.float(), H), expand_groups(Cm.float(), H)
    h = torch.zeros(Bsz, H, Bf.shape[-1], P, dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * A)                              # (B, H)
        h = (dA[:, :, None, None] * h
             + torch.einsum("bhn,bh,bhp->bhnp", Bf[:, t], dtf[:, t],
                            xf[:, t]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _segsum(a):
    """a (B, Q, H) -> (B, H, Q, Q): sum of a over the steps k+1..q at
    [q, k] for k <= q, -inf above the diagonal.  Each entry is a cumsum of
    exactly its own terms, so its f32 error is relative to itself — not to
    the chunk-level cumsum, which at mamba2's decay rates reaches some
    -4000 (the segment-sum form of arXiv:2405.21060's minimal SSD)."""
    Bsz, Q, H = a.shape
    a = a.permute(0, 2, 1)[..., None].expand(Bsz, H, Q, Q)   # [.., d, e] = a_d
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device),
                        diagonal=-1)
    seg = torch.cumsum(a.masked_fill(~strict, 0.0), dim=-2)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~causal, -torch.inf)


def ssd_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """The chunked SSD algorithm that the reference's Pallas kernel
    computes (``repro/kernels/ssd_scan.py`` ``_ssd_kernel``), all in f32:
    within a chunk of Q = min(chunk, S) steps the quadratic
    (C B^T * decay * dt) x product, across chunks the carried state.  The
    decay exponents are segment sums (``_segsum``; the Pallas kernel
    subtracts chunk-level cumsums, ~1e-4 off at mamba2's decay rates) and
    exp of a masked (q < k) exponent is exp(-inf) = 0, never an overflow.

    x (B, S, H, P), dt (B, S, H) f32, A (H,), Bm/Cm (B, S, G, N) with G
    dividing H (head h reads group h // (H // G)).  A ragged last chunk
    is padded with zero dt, which is exact: such a step neither decays
    nor feeds the state, and its y rows are dropped.  Returns (y
    (B, S, H, P) in x's dtype, rounded once; the final state (B, H, N,
    P) f32)."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    xf, dtf = x.float(), dt.float()
    Bf, Cf = expand_groups(Bm.float(), H), expand_groups(Cm.float(), H)
    if pad:
        zp = lambda a: torch.nn.functional.pad(        # noqa: E731
            a, (0, 0) * (a.dim() - 2) + (0, pad))
        xf, dtf, Bf, Cf = zp(xf), zp(dtf), zp(Bf), zp(Cf)
    A = A.float()
    N = Bf.shape[-1]
    h = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        x_, dt_ = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        B_, C_ = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        dA = dt_ * A                                               # (B, Q, H)
        scores = torch.einsum("bqhn,bkhn->bhqk", C_, B_)
        w = (scores * torch.exp(_segsum(dA))
             * dt_.permute(0, 2, 1)[:, :, None, :])               # (B,H,q,k)
        y = torch.einsum("bhqk,bkhp->bqhp", w, x_)
        y = y + (torch.einsum("bqhn,bhnp->bqhp", C_, h)
                 * torch.exp(torch.cumsum(dA, dim=1))[..., None])
        # the sum of dA after each step: a reversed exclusive cumsum
        after = torch.flip(torch.cumsum(torch.flip(dA, [1]), dim=1), [1])
        after = torch.nn.functional.pad(after[:, 1:], (0, 0, 0, 1))
        in_decay = torch.exp(after) * dt_                          # (B, Q, H)
        h = (torch.exp(dA.sum(dim=1))[:, :, None, None] * h
             + torch.einsum("bkhn,bkh,bkhp->bhnp", B_, in_decay, x_))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), h


# ---------------------------------------------------------------------------
# flash attention (K11)
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """The function of the flash-attention kernel in torch ops
    (``repro.kernels.ref.attention_ref``): q (B, Sq, H, E), k/v (B, Sk,
    KV, E) -> (B, Sq, H, E) in q's dtype, GQA groups of M = H / KV query
    heads per KV head, f32 scores, softmax and p·v.  With ``causal`` query
    row s sits at position ``q_offset + s`` and admits key t <= it; a
    ``window`` > 0 also requires position - t < window (a window past
    every position, or None, is full attention, as in the kernel's
    wrapper).  Masked scores are -1e30, as the reference's; any Sq and
    Sk."""
    B, Sq, H, E = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    M = H // KV
    qg = q.reshape(B, Sq, KV, M, E).float()
    s = torch.einsum("bsgme,btge->bgmst", qg, k.float()) / float(E) ** 0.5
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        ok = q_pos[:, None] >= k_pos[None, :]
        if window is not None and window > 0:
            ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(ok[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgmst,btge->bsgme", p, v.float())
    return o.reshape(B, Sq, H, E).to(q.dtype)


# ---------------------------------------------------------------------------
# fused dense MoE (K10)
# ---------------------------------------------------------------------------

def moe_dense_plain(x, router_w, wi, wg, wo, *, act: str = "swiglu"):
    """The function of the fused dense-MoE kernel in torch ops
    (``repro.kernels.ref.moe_dense_ref``): y = Σ_e router_w[:, e] ·
    ffn_e(x) for x (T, d), router_w (T, E) (0 for experts not selected),
    wi/wg (E, d, f), wo (E, f, d) -> (T, d) in x's dtype.  The products
    x·wi, x·wg and h·wo return x's dtype; silu(g)·h (``act="swiglu"``) or
    the tanh-approximated gelu(h) (``act="gelu"``) is taken in f32 and the
    hidden rounded once to x's dtype before wo; the sum over experts is
    f32, weighted by the f32 router weights, and rounded once.  With a
    leading learner axis on every operand (x (L, T, d), router_w (L, T,
    E), wi/wg (L, E, d, f), wo (L, E, f, d)) each learner's tokens go
    through its own experts, batched: the same function per learner."""
    lt = "l" if x.dim() == 3 else ""
    h = torch.einsum(f"{lt}td,{lt}edf->{lt}tef", x, wi)
    if act == "swiglu":
        g = torch.einsum(f"{lt}td,{lt}edf->{lt}tef", x, wg)
        h = torch.nn.functional.silu(g.float()) * h.float()
    elif act == "gelu":
        h = torch.nn.functional.gelu(h.float(), approximate="tanh")
    else:
        raise ValueError(f"act {act!r}: expected 'swiglu' or 'gelu'")
    ye = torch.einsum(f"{lt}tef,{lt}efd->{lt}ted", h.to(x.dtype), wo)
    return torch.einsum(f"{lt}ted,{lt}te->{lt}td", ye.float(),
                        router_w.float()).to(x.dtype)
