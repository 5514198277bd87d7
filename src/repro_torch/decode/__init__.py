"""CTC prefix beam search of the port: plain torch beam (``beam.py``,
``beam_decode`` for TER scoring), the CUDA frame-step kernel with its
wrapper (``kernel.py``), and the exact numpy oracle (``ref.py``, an own
copy of the reference's)."""
from repro_torch.decode.beam import (  # noqa: F401
    BeamState,
    apply_selection,
    beam_decode,
    beam_occupancy,
    beam_search,
    decode_chunk,
    finalize,
    frame_step_scores,
    frame_step_scores_topc,
    gather_rows,
    init_state,
    reset_rows,
    scatter_rows,
    topc_scores,
)
