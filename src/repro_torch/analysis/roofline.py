"""Roofline terms of one NVIDIA H100 — the port of
``repro.analysis.roofline`` for the card the port runs on.

    compute term    = FLOPs            / (chips * peak FLOP/s)
    memory term     = bytes            / (chips * HBM rate)
    collective term = collective bytes / (chips * link rate)

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity)
at its full 700 W power limit; a card set below that limit runs slower
under load, so a share of these peaks is stated beside the card's power
limit.  ``chip_smoke.py`` takes its kernel bounds from :data:`HW`.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str = "NVIDIA H100 80GB HBM3"
    power_limit_w: float = 700.0
    peak_flops_bf16: float = 989e12     # tensor cores, bf16/fp16, dense
    peak_flops_tf32: float = 495e12     # tensor cores, TF32, dense
    peak_flops_f32: float = 67e12       # CUDA cores
    hbm_bw: float = 3.35e12             # bytes/s
    link_bw: float = 450e9              # NVLink 4, bytes/s per direction
    hbm_per_chip: float = 80e9          # bytes


HW = Hardware()


def model_flops(cfg, shape, n_params_active: float, mode: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward only), global: D the
    tokens of the shape (decode: one a sequence)."""
    if mode == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if mode == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch


def roofline_terms(per_device: dict, *, chips: int, hw: Hardware = HW):
    """per_device: {'flops', 'bytes', 'collective_bytes'} of one device
    (``analysis.counts.OpStats``) -> the three terms in seconds, the
    dominant one and its time (``bound_s``)."""
    terms = {"compute_s": per_device["flops"] / hw.peak_flops_bf16,
             "memory_s": per_device["bytes"] / hw.hbm_bw,
             "collective_s": per_device["collective_bytes"] / hw.link_bw}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant.replace("_s", "")
    terms["bound_s"] = terms[dominant]
    return terms
