"""The Mamba-2 block of the ssm family — the port of ``repro.models.ssm``.

The sequence path (prefill) runs the SSD chunked scan [arXiv:2405.21060
§6] through ``kernels.ssd_scan.ssd``: the K9 port on the card, its plain
version on the CPU.  B and C reach the scan per group, (B, S, G, N), so
the group broadcast to the heads is never materialised on the sequence
path.  Decode keeps (conv window, SSM state) per layer and advances them
one token in plain torch ops, as the reference's ``ssd_step`` is plain
jnp: O(1) per token.

Two departures from the reference, both faults of its Pallas path:
a prompt of any length is accepted (the K9 port masks a ragged last
chunk), and a prompt shorter than ``conv_width - 1`` leaves a conv window
left-padded with zeros — the zero-padded causal conv's own history — where
the reference keeps fewer rows and broadcasts them into the slot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.ref import expand_groups
from repro_torch.models.common import linear, per_learner, rmsnorm
from repro_torch.params import ParamSpec


def ssm_dims(cfg):
    """(d_inner, SSM heads) of the block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def ssm_param_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H = ssm_dims(cfg)
    GN = s.n_groups * s.state_dim
    dt = cfg.param_dtype
    W = s.conv_width
    return {
        "wz": ParamSpec((d, d_inner), dt, "lecun",
                        axes=("embed", "ssm_inner")),
        "wx": ParamSpec((d, d_inner), dt, "lecun",
                        axes=("embed", "ssm_inner")),
        "wB": ParamSpec((d, GN), dt, "lecun", axes=("embed", "ssm_state")),
        "wC": ParamSpec((d, GN), dt, "lecun", axes=("embed", "ssm_state")),
        "wdt": ParamSpec((d, H), dt, "lecun", axes=("embed", "ssm_heads")),
        "conv_x": ParamSpec((W, d_inner), "float32", "lecun",
                            axes=(None, "ssm_inner")),
        "conv_B": ParamSpec((W, GN), "float32", "lecun",
                            axes=(None, "ssm_state")),
        "conv_C": ParamSpec((W, GN), "float32", "lecun",
                            axes=(None, "ssm_state")),
        "dt_bias": ParamSpec((H,), "float32", "zeros", axes=("ssm_heads",)),
        "A_log": ParamSpec((H,), "float32", "small_a_log",
                           axes=("ssm_heads",)),
        "D": ParamSpec((H,), "float32", "ones", axes=("ssm_heads",)),
        "norm_scale": ParamSpec((d_inner,), "float32", "ones",
                                axes=("ssm_inner",)),
        "out": ParamSpec((d_inner, d), dt, "lecun",
                         axes=("ssm_inner", "embed")),
    }


def ssm_cache_specs(cfg, batch: int) -> dict:
    """Per-layer decode state: the last ``conv_width - 1`` pre-conv inputs
    of x, B and C (bf16) and the SSM state (batch, H, N, P) f32."""
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    GN = s.n_groups * s.state_dim
    W = s.conv_width
    return {
        "conv": {
            "x": ParamSpec((batch, W - 1, d_inner), "bfloat16", "zeros",
                           axes=("batch", None, "ssm_inner")),
            "B": ParamSpec((batch, W - 1, GN), "bfloat16", "zeros",
                           axes=("batch", None, "ssm_state")),
            "C": ParamSpec((batch, W - 1, GN), "bfloat16", "zeros",
                           axes=("batch", None, "ssm_state")),
        },
        "h": ParamSpec((batch, H, s.state_dim, s.head_dim), "float32",
                       "zeros", axes=("batch", "ssm_heads", "ssm_state",
                                      None)),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv_seq(x, kernel):
    """x (B, S, C); kernel (W, C) depthwise, f32; causal (left) zero
    padding; f32 sums, x's dtype out.  Per learner: x (L, B, S, C),
    kernel (L, W, C)."""
    W, S = kernel.shape[-2], x.shape[-2]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + (xp[..., i:i + S, :].float()
                     * per_learner(kernel[..., i, :], 1, x.dim()))
    return out.to(x.dtype)


def causal_conv_step(buf, xt, kernel):
    """buf (B, W-1, C) previous inputs; xt (B, C).  Returns (new_buf,
    yt)."""
    window = torch.cat([buf, xt[:, None, :]], dim=1)                # (B,W,C)
    yt = (window.float() * kernel).sum(dim=1)
    return window[:, 1:], yt.to(xt.dtype)


def _tail(a, n: int):
    """The last ``n`` rows of a (B, S, C) along S, left-padded with zeros
    when S < n: the window the zero-padded causal conv has seen."""
    S = a.shape[-2]
    return a[..., S - n:, :] if S >= n else F.pad(a, (0, 0, n - S, 0))


# ---------------------------------------------------------------------------
# SSD decode step
# ---------------------------------------------------------------------------

def ssd_step(h, xt, dtt, A, Bt, Ct):
    """One decode step.  h (B, H, N, P) f32; xt (B, H, P); dtt (B, H);
    Bt/Ct (B, H, N).  Returns (h', yt (B, H, P) in xt's dtype)."""
    dA = torch.exp(dtt * A)                                         # (B, H)
    dBx = (Bt.float()[..., :, None] * dtt[..., None, None]
           * xt.float()[..., None, :])
    h = dA[:, :, None, None] * h + dBx
    yt = (Ct.float()[..., None, :] @ h)[..., 0, :]
    return h, yt.to(xt.dtype)


# ---------------------------------------------------------------------------
# Full mamba2 block
# ---------------------------------------------------------------------------

def _projections(p, x):
    z = linear(x, p["wz"])
    xi = linear(x, p["wx"])
    Bp = linear(x, p["wB"])
    Cp = linear(x, p["wC"])
    dt_raw = linear(x.float(), p["wdt"].float())
    return z, xi, Bp, Cp, dt_raw


def _gate_out(cfg, p, y, xh, z):
    """y += D x; RMSNorm of y * silu(z); the output projection."""
    d_inner = ssm_dims(cfg)[0]
    D = per_learner(p["D"][..., None], 2, xh.dim())
    y = y + (D * xh.float()).to(y.dtype)
    y = y.reshape(*y.shape[:-2], d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"])
    return linear(y, p["out"])


def mamba2_seq(cfg, p, x):
    """Full-sequence mamba2 block.  x (B, S, d) -> (y (B, S, d),
    (conv_state, ssm_state)): conv_state the last ``conv_width - 1``
    pre-conv inputs {'x', 'B', 'C'} (zero rows first when S is shorter),
    ssm_state (B, H, N, P) f32.  With learner-stacked weights, x (L, B,
    S, d) and every output with a leading L: the projections and the
    conv per learner, the scan one ``ssd_learners`` call (K9 with the
    learners folded into its heads on the card)."""
    s = cfg.ssm
    H = ssm_dims(cfg)[1]
    lead = x.shape[:-1]                                   # (B, S) or (L, B, S)
    z, xi, Bp, Cp, dt_raw = _projections(p, x)
    xi_c = F.silu(causal_conv_seq(xi, p["conv_x"]))
    Bp_c = F.silu(causal_conv_seq(Bp, p["conv_B"]))
    Cp_c = F.silu(causal_conv_seq(Cp, p["conv_C"]))
    dt = F.softplus(dt_raw + per_learner(p["dt_bias"], 1, x.dim()))  # f32
    A = -torch.exp(p["A_log"])
    xh = xi_c.reshape(*lead, H, s.head_dim)
    grouped = (*lead, s.n_groups, s.state_dim)
    scan = SSD.ssd_learners if x.dim() == 4 else SSD.ssd
    y, h_final = scan(xh, dt, A, Bp_c.reshape(grouped),
                      Cp_c.reshape(grouped), chunk=s.chunk)
    out = _gate_out(cfg, p, y, xh, z)
    n = s.conv_width - 1
    conv_state = {"x": _tail(xi, n), "B": _tail(Bp, n), "C": _tail(Cp, n)}
    return out, (conv_state, h_final)


def mamba2_step(cfg, p, xt, conv_state, h):
    """One-token decode.  xt (B, 1, d) -> (y (B, 1, d), (new conv_state,
    new ssm_state))."""
    s = cfg.ssm
    H = ssm_dims(cfg)[1]
    z, xi, Bp, Cp, dt_raw = _projections(p, xt)
    cs_x, xi_t = causal_conv_step(conv_state["x"], xi[:, 0], p["conv_x"])
    cs_B, Bp_t = causal_conv_step(conv_state["B"], Bp[:, 0], p["conv_B"])
    cs_C, Cp_t = causal_conv_step(conv_state["C"], Cp[:, 0], p["conv_C"])
    xi_t, Bp_t, Cp_t = F.silu(xi_t), F.silu(Bp_t), F.silu(Cp_t)
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    B_ = xt.shape[0]
    xh = xi_t.reshape(B_, H, s.head_dim)
    grouped = (B_, s.n_groups, s.state_dim)
    h, yt = ssd_step(h, xh, dt, A, expand_groups(Bp_t.reshape(grouped), H),
                     expand_groups(Cp_t.reshape(grouped), H))
    out = _gate_out(cfg, p, yt[:, None], xh[:, None], z)
    return out, ({"x": cs_x, "B": cs_B, "C": cs_C}, h)
