"""The public kernel wrappers — the port of ``repro.kernels.ops``, under
the reference's names.  Each is the port's hand-written CUDA kernel's
wrapper: the kernel on a CUDA tensor, its plain version on a CPU tensor
(``repro_torch.device.plain_path``).  The reference's ``kernel_impl``
switch has no counterpart.

The reference's TPU tiling arguments are left out: ``block_q`` and
``block_k`` (flash attention's VMEM tiles), ``block_b`` and
``vmem_budget`` (the LSTM kernels' batch tile and VMEM budget) and
``tile_t`` (the dense MoE's token tile) size blocks of a TPU's vector
memory.  The H100 kernels plan their own tiles from the shapes and the
card (``flash_attention.plan``, ``lstm_cell.recur_plan`` and
``stack_plan``, ``moe_dense.launch_plan``, ``ssd_scan.ssd_plan``), so
these knobs would mean nothing here; the train CLI leaves out
``--block-b`` and ``--vmem-budget-mb`` for the same reason.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lstm_cell as _lc
from repro_torch.kernels.flash_attention import flash_attention as attention
from repro_torch.kernels.lstm_cell import blstm_sequence, lstm_sequence
from repro_torch.kernels.moe_dense import moe_dense
from repro_torch.kernels.ssd_scan import ssd

__all__ = ["attention", "lstm_sequence", "blstm_sequence", "blstm_stack",
           "ssd", "moe_dense"]


def blstm_stack(params, x, lengths=None, *, stash_dtype: str = None,
                seq_chunk: int = 0):
    """The fused BLSTM stack: ``params`` a sequence of per-layer (wxf,
    whf, bf, wxb, whb, bb).  Inference is one launch of K4; under a
    gradient each layer runs :func:`blstm_sequence` (the per-layer
    stashing VJP, honouring ``stash_dtype`` and ``seq_chunk``), as the
    reference's custom VJP does."""
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for ws in params for t in ws)):
        return _lc.blstm_stack(params, x, lengths)
    one = x.dim() == 3
    if one:
        x = x.unsqueeze(0)
        lengths = None if lengths is None else lengths.unsqueeze(0)
    for ws in params:
        x = blstm_sequence(*(w.unsqueeze(0) if one else w for w in ws), x,
                           lengths, stash_dtype=stash_dtype,
                           seq_chunk=seq_chunk)
    return x.squeeze(0) if one else x
