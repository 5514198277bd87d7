"""Recognition-quality metrics: an own copy of ``repro.eval.metrics``."""
from repro_torch.eval.metrics import (  # noqa: F401
    collapse_labels,
    edit_distance,
    frame_error_rate,
    greedy_ctc_decode,
    token_error_rate,
)
