"""Meshes — the port of ``repro.launch.mesh``.

The reference lays its programs over TPU meshes: one pod (16, 16) = 256
chips, axes ('data', 'model'), or two pods (2, 16, 16) = 512, axes
('pod', 'data', 'model'), with the learner ring of AD-PSGD on 'data'
(one pod) or 'pod' (the H-ring).  A :class:`Mesh` here is a description:
axis names and sizes, the devices it is laid over and this process's own
— none for the production geometries, which exist only for the
dry-run's per-device accounting (``launch/dryrun.py --mesh
pod|multipod``).  :func:`make_local_mesh` describes the world of ranks:
'data' is the W processes of a ``torchrun`` launch (each holding a block
of the learner axis, ``core/collective.py``), their cards (or the CPU)
the devices.  Nothing is placed by it: each rank's tensors live on its
own device, and the learner axis crosses ranks through
``core/collective.py``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from repro_torch.sharding import MeshRules, default_rules, multipod_rules


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes (``shape``, as ``jax.sharding.Mesh.shape``),
    the devices of a mesh laid over real ones (empty: abstract), one a
    rank along 'data', and this process's own device."""

    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = field(default=(), compare=False)
    device: torch.device = field(default=None, compare=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def abstract(self) -> bool:
        return not self.devices


def use_mesh(mesh):
    """The reference's mesh context; each rank's tensors already live on
    its device, so there is nothing to activate: a no-op context."""
    return contextlib.nullcontext(mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production geometry, abstract: (16, 16) = 256
    devices ('data', 'model'), or (2, 16, 16) = 512 ('pod', 'data',
    'model')."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """The (data, model) mesh of this run: 'data' = the W ranks of the
    process group (1 in a single process), ``devices`` each rank's device
    and ``device`` this rank's, as ``multihost.placement()`` gives them.  In
    one process the devices are the local CUDA cards, or the CPU where
    ``device`` is 'cpu' or no card is present, and, as the reference's,
    ``data`` is clamped to the devices there are and 'model' takes the
    rest; ``model`` is accepted for its signature."""
    from repro_torch.launch import multihost

    place = multihost.placement()
    if place is not None:
        return Mesh(("data", "model"), (place.world, 1), place.devices,
                    place.device)
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda")
    if dev is None or dev.type != "cuda":
        devices = (torch.device("cpu"),)
    else:
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    n = len(devices)
    data = min(data, n)
    return Mesh(("data", "model"), (data, max(n // data, 1)), devices,
                devices[0])


def rules_for(cfg, mesh, *, multi_pod: bool = False) -> MeshRules:
    """MeshRules for one architecture on one mesh (FSDP and the expert
    axis from the arch's fields); ``attn_sharding == "seq"`` shards the
    projections' contracting head_dim over 'model'."""
    mk = multipod_rules if multi_pod else default_rules
    rules = mk(fsdp=cfg.fsdp, expert_axis=cfg.expert_axis)
    if getattr(cfg, "attn_sharding", "replicated") == "seq":
        rules["head_dim"] = ("model",)
    return MeshRules(mesh, rules)
