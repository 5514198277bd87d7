"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
module names so each counterpart is easy to find.  It imports torch,
numpy and the standard library only — never ``jax`` and never anything
under ``repro.``: what it needs of the reference's numpy-only modules it
keeps as its own copy.

Ported so far, each on hand-written CUDA kernels for sm_90a:
streaming-ASR serving of the paper's BLSTM acoustic model
(``launch/serve.AsrServer``: the fused BLSTM forward
``kernels/csrc/lstm_fwd.cu`` and the CTC prefix-beam frame step
``decode/csrc/beam_step.cu``); the paper's distributed training step
(``launch/train``: the stashing forward and ``kernels/csrc/lstm_bwd.cu``);
and continuous-batching LM serving of the dense decoder
(``launch/serve.Server``/``PagedServer``: the decode-attention kernels
``kernels/csrc/decode_attention.cu`` and the argmax
``decode/csrc/argmax.cu``).

Entry points put tensors on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version (see :mod:`repro_torch.device`).
"""
