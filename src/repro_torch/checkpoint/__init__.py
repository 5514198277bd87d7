"""Atomic, validated checkpoints of the port's train state."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step,
    latest_steps,
    restore,
    save,
)
