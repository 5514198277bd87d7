"""Communication substrate — the port of the f32 fast path of
``repro.core.transport.Transport``.

A :class:`Transport` names who exchanges with whom (``topology``) and the
codec of what crosses the wire (``wire``).  On one card the learners are
one stacked axis, so a mixing round is a tensor op over that axis; this
port holds the exact-arithmetic (f32-wire, unbucketed) ``ring`` and
``uniform`` topologies, which delegate to :mod:`repro_torch.core.mixing`
exactly as the reference's fast path does (``transport.py:257-297``),
and ``wire_bytes``, the analytic bytes each learner sends per round.
Every other topology, wire codec or bucketing raises
``NotImplementedError`` naming its ROADMAP.md item by title (queue 1:
"Topologies and strategies not yet ported", "Wire codecs and
bucketing").
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import mixing

TOPOLOGIES = ("none", "uniform", "ring", "hierarchical", "exp")
WIRES = ("f32", "bf16", "int8", "topk")
_PORTED_TOPOLOGIES = ("uniform", "ring")
_TOPOLOGY_TODO = ("not ported yet: ROADMAP.md queue 1, 'Topologies and "
                  "strategies not yet ported'")
_WIRE_TODO = "not ported yet: ROADMAP.md queue 1, 'Wire codecs and bucketing'"


def _ring_sends(G: int) -> float:
    """Payloads each member sends per T_1 round: both neighbors (2), the
    single neighbor when G==2, nothing when alone."""
    return 0.0 if G <= 1 else (1.0 if G == 2 else 2.0)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


@dataclass(frozen=True)
class Transport:
    """One communication configuration (``repro.core.transport``)."""

    topology: str = "ring"
    wire: str = "f32"
    bucket_bytes: int = 0        # 0 = one fused payload per tensor

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"expected one of {TOPOLOGIES}")
        if self.wire not in WIRES:
            raise ValueError(f"unknown wire {self.wire!r}; expected one of "
                             f"{WIRES}")
        if self.topology not in _PORTED_TOPOLOGIES:
            raise NotImplementedError(
                f"topology {self.topology!r} is {_TOPOLOGY_TODO}")
        if self.wire != "f32":
            raise NotImplementedError(f"wire {self.wire!r} is {_WIRE_TODO}")
        if self.bucket_bytes:
            raise NotImplementedError(
                f"bucketed payloads are {_WIRE_TODO}")

    def make_mixer(self, n_learners: int):
        """``mix(params, step, comm) -> (mixed, comm)`` over the stacked
        learner axis (the reference's f32 fast path)."""
        if self.topology == "uniform":
            return lambda p, step, comm: (mixing.mix_uniform(p), comm)
        return lambda p, step, comm: (mixing.mix_ring(p), comm)

    def wire_bytes(self, params) -> float:
        """Analytic bytes SENT per learner per mixing round, from leaf
        shapes only: ring = 2 payloads (1 when L == 2), uniform =
        2(L-1)/L (ring-allreduce schedule), 4 bytes an element."""
        total = 0.0
        for leaf in _leaves(params):
            L = int(leaf.shape[0])
            n = int(np.prod(leaf.shape[1:])) if len(leaf.shape) > 1 else 1
            mult = (_ring_sends(L) if self.topology == "ring"
                    else 2.0 * (L - 1) / L)
            total += mult * 4.0 * n
        return total
