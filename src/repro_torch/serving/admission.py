"""Typed admission results — the port's own copy of the part of
``repro/serving/admission.py`` the ASR server needs (docs/serving.md
§Admission)."""
from __future__ import annotations

from dataclasses import dataclass

# typed admission outcomes
OK = "ok"                          # admitted into a slot
POOL_FULL = "pool_full"            # every slot busy (retryable)
PROMPT_TOO_LONG = "prompt_too_long"  # payload exceeds the slot capacity
NO_BUDGET = "no_budget"            # nothing to decode (max_new/frames <= 0)


@dataclass(frozen=True)
class AdmitResult:
    """Typed admission outcome; truthy iff admitted."""

    reason: str
    slot: int = -1

    def __bool__(self) -> bool:
        return self.reason == OK


def prompt_capacity(max_len: int, mode: str) -> int:
    """Payload capacity of a slot: ``lm`` reserves one of ``max_len``
    cache positions for the first generated token; ``asr`` may fill the
    whole ``max_len``-frame posterior buffer."""
    if mode == "lm":
        return max_len - 1
    if mode == "asr":
        return max_len
    raise ValueError(f"unknown payload mode {mode!r}")
