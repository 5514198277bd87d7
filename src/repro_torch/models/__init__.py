"""Model families of the port: the paper's BLSTM acoustic model and the
dense decoder-only transformer."""
from repro_torch.models.api import Model, build_model  # noqa: F401
