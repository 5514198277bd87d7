"""Multi-process launch scaffolding — the port of
``repro.launch.multihost``.

``initialize()`` wires ``torch.distributed`` from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or from its arguments (a
``file://`` rendezvous, as the tests use); in a single process it does
nothing and returns False, as the reference's does.  The
backend follows the placement, decided before the group exists: ``nccl``
when every local rank has a card of its own (rank k on ``cuda:k``), and
``gloo`` on the CPU or when the local ranks outnumber the cards and share
them (NCCL refuses two ranks on one device; gloo's CUDA payloads are
staged through host memory, ``core/collective.py``).  A run that asks
for the card on a machine without one raises; no rank carries on on the
CPU.  :func:`placement` describes the choice for the run's header line.

``host_batch_slice`` gives this process's rows of a global batch and
``learner_block`` its learners; ``make_global_batch`` puts this rank's
rows on its device.

    python -m repro_torch.launch.train ...        # one process
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch swb2000-blstm --learners 16 ...    # one rank a card
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.collective import learner_block, world


class Placement(NamedTuple):
    """Where this process runs: the backend, its rank and the world size,
    its device, whether its CUDA payloads are staged through host memory
    (gloo on a card), and every rank's device (one host: rank k's local
    rank is k mod the local world)."""

    backend: str
    rank: int
    world: int
    device: torch.device
    staged: bool
    devices: tuple

    def describe(self) -> str:
        how = ("payloads staged through host memory" if self.staged
               else "payloads card to card" if self.device.type == "cuda"
               else "payloads in host memory")
        return (f"{self.backend}: rank {self.rank} of {self.world} on "
                f"{self.device}, {how}")


_PLACEMENT = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def choose_placement(device=None, *, rank: int, world_size: int,
                     local_rank: int, local_world: int) -> Placement:
    """The backend and device of one rank: the CPU under gloo when
    ``device`` is 'cpu'; otherwise the card, which must exist
    (RuntimeError), ``cuda:local_rank`` under nccl when the local ranks
    have a card each, else ``cuda:(local_rank mod cards)`` under gloo."""
    if device is not None and torch.device(device).type == "cpu":
        cpu = torch.device("cpu")
        return Placement("gloo", rank, world_size, cpu, False,
                         (cpu,) * world_size)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to this rank; pass --device cpu "
            "to run every rank's plain PyTorch path on the CPU")
    cards = torch.cuda.device_count()
    devices = tuple(torch.device("cuda", (r % local_world) % cards)
                    for r in range(world_size))
    shared = local_world > cards
    return Placement("gloo" if shared else "nccl", rank, world_size,
                     torch.device("cuda", local_rank % cards), shared,
                     devices)


def initialize(coordinator: str = "", num_processes: int = 0,
               process_id: int = -1, *, device=None, init_method: str = "",
               timeout: float = 0) -> bool:
    """Initialise ``torch.distributed`` when running multi-process; a
    no-op returning False in a single process.

    The ranks meet at ``init_method`` (``tcp://host:port`` or
    ``file://<path>``), by default ``tcp://`` at ``coordinator``
    "host:port", else at torchrun's MASTER_ADDR:MASTER_PORT; the group
    has ``num_processes`` ranks (else WORLD_SIZE), this one
    ``process_id`` (else RANK), placed by LOCAL_RANK and
    LOCAL_WORLD_SIZE (else the rank and the group's size,
    :func:`choose_placement`).  ``device`` 'cpu' runs every rank on the
    CPU; otherwise each rank makes its card the current device before
    the group exists.  ``timeout`` (seconds) bounds a collective's wait.
    A later call in a process whose group it made returns True."""
    global _PLACEMENT
    dist = torch.distributed
    if _PLACEMENT is not None and dist.is_initialized():
        return True
    if not init_method:
        if not coordinator and os.environ.get("MASTER_ADDR"):
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        init_method = f"tcp://{coordinator}" if coordinator else ""
    num_processes = num_processes or _env_int("WORLD_SIZE", 0)
    if not init_method or num_processes <= 1:
        return False
    rank = process_id if process_id >= 0 else _env_int("RANK", 0)
    place = choose_placement(
        device, rank=rank, world_size=num_processes,
        local_rank=_env_int("LOCAL_RANK", rank),
        local_world=_env_int("LOCAL_WORLD_SIZE", num_processes))
    if place.device.type == "cuda":
        torch.cuda.set_device(place.device)
    kw = {"device_id": place.device} if place.backend == "nccl" else {}
    if timeout:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(place.backend, init_method=init_method,
                            world_size=num_processes, rank=rank, **kw)
    _PLACEMENT = place
    return True


def placement() -> Placement:
    """This process's placement, the one :func:`initialize` chose; None
    in a single process."""
    if _PLACEMENT is not None and world()[1] > 1:
        return _PLACEMENT
    return None


def host_batch_slice(global_batch: int):
    """(start, size) of this process's rows of the global batch, the batch
    split over processes in rank order."""
    idx, n = world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} processes")
    per = global_batch // n
    return idx * per, per


def make_global_batch(batch_np: dict, mesh, rules, input_axes: dict):
    """The global batch's numpy rows -> this rank's rows
    (:func:`host_batch_slice`) as tensors on the mesh's device for this
    rank (``input_axes``: leaf name -> logical axes, as
    ``Model.input_specs`` gives them; checked against each leaf's rank).
    In one process, the whole batch."""
    device = getattr(mesh, "device", None) or "cpu"
    out = {}
    for k, v in batch_np.items():
        v = np.asarray(v)
        rules.spec(v.shape, input_axes[k])       # rank and rules agree
        start, size = host_batch_slice(v.shape[0])
        out[k] = torch.from_numpy(np.array(v[start:start + size],
                                           copy=True)).to(device)
    return out


__all__ = ["Placement", "choose_placement", "initialize", "placement",
           "host_batch_slice", "learner_block", "make_global_batch"]
