"""Communication compression, kept for the reference's callers — the port
of ``repro.core.compression``.

The quantizers are wire codecs of the substrate
(:mod:`repro_torch.core.transport`): the bespoke ``mix_ring_q8`` mixer is
exactly ``Transport(topology='ring', wire='int8')``, and the int8/topk
codecs compose with every topology and strategy there.  Kept here,
anchored in the paper's §IV-D survey of 1-bit SGD [Seide'14], QSGD
[Alistarh'17] and sparsification [Aji'17]:

* ``quantize_int8``/``dequantize_int8``: the per-tensor symmetric linear
  quantizer (the transport's int8 codec applies it per sender);
* ``mix_ring_q8``: a thin shim over the substrate;
* ``make_exp_mixer``: re-exported from :mod:`repro_torch.core.mixing`
  (it is pure topology, not compression).
"""
from __future__ import annotations

import torch

from repro_torch.core.mixing import div
from repro_torch.core.mixing import make_exp_mixer  # noqa: F401  (compat)


def quantize_int8(x: torch.Tensor):
    """x (any float) -> (int8 payload, f32 scale). Symmetric, per-tensor."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def mix_ring_q8(params):
    """Ring (T_1) mixing with int8 neighbour payloads: a shim over
    ``Transport(topology='ring', wire='int8')`` (per-sender scales).  Each
    learner sends q8(w_l) to both ring neighbours; the local replica stays
    full precision."""
    from repro_torch.core.transport import Transport, _leaves

    leaves = list(_leaves(params))
    L = leaves[0].shape[0] if leaves else 1
    mixed, _ = Transport(topology="ring", wire="int8").make_mixer(L)(
        params, 0, {})
    return mixed
