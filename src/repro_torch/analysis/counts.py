"""The op counter — the counterpart of ``repro.analysis.hlo`` for eager
PyTorch.

The reference compiles a step and walks its HLO (with while-loop trip
counts).  PyTorch has no HLO: what runs is the eager stream of aten ops,
so :func:`count` runs a step on fake tensors (``FakeTensorMode``: shapes
and dtypes, no data, no allocation) under a ``TorchDispatchMode`` that
sees every aten op and counts

* ``flops``: the products only, from ``torch.utils.flop_counter``'s
  formulas (2·M·N·K per matrix product, and convolutions and attention
  by theirs), as the HLO analyzer counts dot ops alone;
* ``bytes``: each op's tensor inputs plus its outputs.  XLA counts after
  fusion; eager PyTorch runs each op on its own, so this is the unfused
  traffic, an upper bound on what a fused program moves;
* ``collectives``: the c10d functional ops by kind ({'bytes', 'count'});
  a one-card step has none;
* ``peak_bytes``: the most bytes of fake storage alive at once while the
  step ran, its arguments included: a storage counts from the op that
  makes it until the last tensor over it dies (tensors the autograd
  graph saves stay alive with the graph), the step's own
  ``memory_allocated`` high-water mark without the allocator's rounding
  and caching;
* ``n_ops``: the aten ops dispatched, and ``flops_by_op`` the flops of
  each op kind.

Every Python-level loop runs (layers, microbatches, frames), so each op
is counted as often as it executes: no trip counts to recover.  A host
read of a tensor's value (``.item()``, ``.tolist()``) cannot run on fake
tensors, so a step that needs one is not countable as it is.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")


@dataclass
class OpStats:
    """The counts of one step (per device: the port's steps run on one)."""

    flops: float
    bytes: float
    collectives: dict = field(default_factory=dict)
    n_ops: int = 0
    peak_bytes: int = 0
    flops_by_op: dict = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def to_json(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives,
                "collective_bytes": self.collective_bytes,
                "n_ops": self.n_ops, "peak_bytes": self.peak_bytes,
                "flops_by_op": self.flops_by_op}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op = {}
        self.bytes = 0
        self.n_ops = 0
        self.collectives = {}
        self.live = 0
        self.peak = 0
        self._seen = set()          # ids of the storages being tracked

    def track(self, t: torch.Tensor):
        """Count ``t``'s storage as alive until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            name = packet.__name__
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        moved = sum(_nbytes(t) for t in ins + outs)
        self.bytes += moved
        if func.namespace in _COLLECTIVE_NS:
            c = self.collectives.setdefault(packet.__name__,
                                            {"bytes": 0, "count": 0})
            c["bytes"] += sum(_nbytes(t) for t in ins)
            c["count"] += 1
        for t in outs:
            self.track(t)
        return out


def count(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` on fake tensors and count its ops.

    Tensor arguments must be fake tensors of one ``FakeTensorMode``
    (``repro_torch.sharding.spec_tree_to_fake`` made inside it), or real
    ones, which are converted; their storages count toward
    ``peak_bytes`` from the start.  Returns the :class:`OpStats` and
    leaves the fake outputs to the garbage collector."""
    stats, _ = count_with_output(fn, *args, **kwargs)
    return stats


def _fake_mode(tree):
    for t in _tensors(tree):
        mode = getattr(t, "fake_mode", None)
        if mode is not None:
            return mode
    return FakeTensorMode(allow_non_fake_inputs=True)


def count_with_output(fn, *args, **kwargs):
    """:func:`count`, and the step's (fake) output."""
    mode = _fake_mode((args, kwargs))
    counter = _Counter()
    # the graph keeps the Python tensors it saves, so a saved activation's
    # storage stays counted as long as the graph holds it
    hooks = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                     lambda t: t)
    with mode, hooks:
        for t in _tensors((args, kwargs)):
            counter.track(t)
        with counter:
            out = fn(*args, **kwargs)
    stats = OpStats(flops=float(counter.flops), bytes=float(counter.bytes),
                    collectives=counter.collectives, n_ops=counter.n_ops,
                    peak_bytes=int(counter.peak),
                    flops_by_op=counter.flops_by_op)
    return stats, out
