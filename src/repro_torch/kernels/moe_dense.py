"""The fused dense mixture of experts: the wrapper of the K10 port, the
dense router's FFN of the moe family on the card.

``moe_dense`` has the contract of ``repro.kernels.moe_dense.moe_dense``:
x (T, d), router_w (T, E) combine weights (0 for experts not selected),
wi/wg (E, d, f), wo (E, f, d) -> y (T, d) in x's dtype, y = Σ_e
router_w[:, e] · ffn_e(x), ffn_e(x) = (silu(x wg_e) · x wi_e) wo_e
(``act="swiglu"``) or gelu(x wi_e) wo_e (``act="gelu"``, the tanh
approximation; wg is then not read).  One extension: any T >= 1 (the
Pallas kernel asserts T % tile_t == 0).

On a CUDA tensor it launches ``csrc/moe_dense.cu`` (the fused kernel and
its short pass over the expert-group partials) and counts one launch
(``launches``); on a CPU tensor it runs the plain version
(``ref.moe_dense_plain``).  It never falls back from the card to the
plain path.  The kernel keeps x·wi, x·wg and the hidden times wo in f32
where the plain version rounds each product to bf16, as the reference
oracle does: the two agree within the bf16 output's tolerance, 2e-2 of
each token row's largest value.  A token's output is bit-identical
whatever T is and whichever tokens share its tile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_kernel_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_dense_plain

launches = 0          # K10 launches (one per moe_dense on the card)

ACTS = ("swiglu", "gelu")
HIDDEN_PER_CTA = 64   # hidden columns a CTA of a cluster computes
MAX_CLUSTER = 8       # CTAs per cluster: f / 64 <= 8, so f <= 512
MAX_OUT_PER_CTA = 192  # output columns d / (f / 64) a CTA accumulates
EXPERTS_PER_GROUP = 2  # experts a CTA sums before one f32 partial

_P = ctypes.c_void_p
_I = ctypes.c_int


def expert_groups(E: int) -> int:
    """The number of f32 partials of y the kernel sums per element."""
    return -(-E // EXPERTS_PER_GROUP)


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


def _check_kernel_shapes(d: int, f: int):
    cl = f // HIDDEN_PER_CTA
    if f % HIDDEN_PER_CTA or not 1 <= cl <= MAX_CLUSTER:
        raise ValueError(f"d_ff {f}: the kernel takes a multiple of "
                         f"{HIDDEN_PER_CTA} up to "
                         f"{HIDDEN_PER_CTA * MAX_CLUSTER}")
    if d % (64 * cl) or d // cl > MAX_OUT_PER_CTA:
        raise ValueError(f"d_model {d}: the kernel splits it over {cl} CTAs "
                         f"in multiples of 64 up to {MAX_OUT_PER_CTA} each")


def moe_dense(x, router_w, wi, wg, wo, *, act: str = "swiglu"):
    """x (T, d) bf16, router_w (T, E) f32, wi/wg (E, d, f) bf16, wo
    (E, f, d) bf16 -> y (T, d) bf16."""
    global launches
    _check(x, router_w, wi, wg, wo, act)
    if x.device.type == "cpu":
        return moe_dense_plain(x, router_w, wi, wg, wo, act=act)
    require_kernel_device(x)
    T, d = x.shape
    E, _, f = wi.shape
    _check_kernel_shapes(d, f)
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
    y = torch.empty_like(x)
    partial = torch.empty(expert_groups(E), T, d, dtype=torch.float32,
                          device=dev)
    lib = build.load("moe_dense")
    if lib.moe_dense.argtypes is None:
        lib.moe_dense.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        lib.moe_dense.restype = _I
    rc = lib.moe_dense(x.data_ptr(), router_w.data_ptr(), wi.data_ptr(),
                       wg.data_ptr(), wo.data_ptr(), y.data_ptr(),
                       partial.data_ptr(), T, d, E, f, int(act == "gelu"),
                       EXPERTS_PER_GROUP,
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"moe_dense launch failed: cudaError {rc}")
    launches += 1
    return y
