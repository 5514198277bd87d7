"""Model families of the port: the paper's BLSTM acoustic model (with
frame CE or the CTC loss, ``ctc.py``), the dense decoder-only transformer
and the attention-free Mamba-2 stack."""
from repro_torch.models.api import Model, build_model  # noqa: F401
