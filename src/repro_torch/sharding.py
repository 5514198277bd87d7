"""Logical-axis sharding rules — the port of ``repro.sharding``.

Every parameter and input dimension carries a logical axis name
('heads', 'mlp', 'batch', ...; ``ParamSpec.axes``).  :class:`MeshRules`
maps logical axes to mesh axes: each logical axis has an ordered list of
candidates, and the first mesh axis (or tuple of axes) not yet used in
the spec whose size divides the dimension wins — the reference's greedy,
divisibility-aware assignment, so that phi-3's 40 heads fall through
where command-r's 64 would shard.

One card places nothing.  The port runs on one H100, so no tensor is
ever laid out by these rules: they compute what the reference's GSPMD
placement would be on its production geometries
(``launch/mesh.make_production_mesh``), which the dry-run reads as the
per-device shapes and bytes of a pod (``launch/dryrun.py --mesh pod``),
and :func:`spec_tree_to_fake` builds the stand-in tensors of a spec
tree.  A spec is a tuple with one entry per dimension: None, a mesh
axis's name, or a tuple of names (the reference's ``PartitionSpec``
entries).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.params import ParamSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

def default_rules(*, fsdp: bool = False, expert_axis: str = "",
                  learner_axis: str = "data") -> dict:
    """Logical axis -> ordered mesh-axis candidates
    (``repro.sharding.default_rules``).  ``learner_axis`` is where the
    decentralized learner replicas live: 'data' on one pod, 'pod' for the
    H-ring multi-pod configuration."""
    return {
        "learner": (learner_axis,),
        # parameters
        "vocab": ("model",),
        "embed": ("data",) if fsdp else (),
        "mlp": ("model",),
        # attention weights replicate over 'model' (no assigned GQA config
        # has heads divisible by the 16-way axis)
        "heads": (),
        "kv_heads": (),
        "head_dim": (),
        "qkv": (),
        "experts": (expert_axis,) if expert_axis else (),
        "expert_mlp": ("model",),
        "ssm_heads": ("model",),
        "ssm_inner": ("model",),
        "ssm_state": (),
        "conv_dim": (),
        "layers": (),
        "lstm_hidden": ("model",),
        "lstm_gates": ("model",),
        "feature": (),
        "bottleneck": (),
        # activations
        "batch": ("data",),
        "seq": (),
        # decode KV caches shard their time axis over model x data, else
        # model, else data
        "cache_seq": (("model", "data"), "model", "data"),
        "frames": (),
        None: (),
    }


def multipod_rules(*, fsdp: bool = False, expert_axis: str = "") -> dict:
    """Multi-pod mesh ('pod', 'data', 'model'): learners ride the pod
    axis, the batch shards over data."""
    rules = default_rules(fsdp=fsdp, expert_axis=expert_axis,
                          learner_axis="pod")
    rules["batch"] = ("data",)
    return rules


# ---------------------------------------------------------------------------
# MeshRules
# ---------------------------------------------------------------------------

@dataclass
class MeshRules:
    """Rules over a mesh: anything with a ``shape`` mapping of axis name
    -> size (``launch.mesh.Mesh``, or a duck-typed stand-in)."""

    mesh: object
    rules: dict

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    def _group_size(self, group) -> int:
        size = 1
        for a in group:
            size *= self.axis_size(a)
        return size

    def spec(self, shape: Sequence[int],
             axes: Sequence[Optional[str]]) -> tuple:
        """Greedy left-to-right assignment: each mesh axis used at most
        once per spec; a candidate must evenly divide its dimension."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in rank")
        out = [None] * len(shape)
        used = set()
        for i, (n, ax) in enumerate(zip(shape, axes)):
            for cand in self.rules.get(ax, ()):
                if not cand:
                    continue
                group = cand if isinstance(cand, tuple) else (cand,)
                if used.isdisjoint(group) and n % self._group_size(group) == 0:
                    out[i] = cand
                    used.update(group)
                    break
        return tuple(out)

    def local_shape(self, shape: Sequence[int],
                    axes: Sequence[Optional[str]]) -> tuple:
        """The per-device shape under :meth:`spec`: each sharded
        dimension divided by the size of its mesh axes."""
        out = []
        for n, entry in zip(shape, self.spec(shape, axes)):
            if entry is None:
                out.append(int(n))
                continue
            group = entry if isinstance(entry, tuple) else (entry,)
            out.append(int(n) // self._group_size(group))
        return tuple(out)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def _lead(ps: ParamSpec, extra_leading: tuple):
    shape = tuple(s for s, _ in extra_leading) + tuple(ps.shape)
    axes = tuple(a for _, a in extra_leading) + tuple(ps.axes)
    return shape, axes


def spec_tree_to_fake(spec_tree, extra_leading: tuple = (), *,
                      device="meta"):
    """A spec tree -> tensors of its shapes and dtypes that hold no data:
    ``meta`` tensors by default, or, made inside a ``FakeTensorMode``,
    fake tensors on ``device`` (``repro.sharding.spec_tree_to_sds``, with
    no sharding to attach on one card).  ``extra_leading`` prepends
    (size, logical axis) dimensions (the learner axis of a decentralized
    strategy)."""
    def one(ps):
        shape, _ = _lead(ps, extra_leading)
        return torch.empty(shape, dtype=_DTYPES[ps.dtype], device=device)
    return _map_specs(one, spec_tree)


def spec_tree_shardings(spec_tree, mesh_rules: MeshRules,
                        extra_leading: tuple = ()):
    """A spec tree -> the tree of its specs under ``mesh_rules``
    (``repro.sharding.spec_tree_shardings``)."""
    return _map_specs(lambda ps: mesh_rules.spec(*_lead(ps, extra_leading)),
                      spec_tree)


def spec_tree_bytes(spec_tree, mesh_rules: Optional[MeshRules] = None,
                    extra_leading: tuple = ()) -> int:
    """The bytes of a spec tree's tensors: whole, or per device under
    ``mesh_rules``."""
    if isinstance(spec_tree, dict):
        return sum(spec_tree_bytes(v, mesh_rules, extra_leading)
                   for v in spec_tree.values())
    shape, axes = _lead(spec_tree, extra_leading)
    if mesh_rules is not None:
        shape = mesh_rules.local_shape(shape, axes)
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPES[spec_tree.dtype].itemsize
