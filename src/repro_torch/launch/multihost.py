"""Multi-process launch scaffolding — the port of
``repro.launch.multihost``.

``initialize()`` wires ``torch.distributed`` from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or from its
arguments; in a single process it does nothing and returns False, as the
reference's does.  ``host_batch_slice`` gives this process's rows of a
global batch.  The port runs on one card: ``make_global_batch`` puts the
rows on the mesh's device in a single process, and raises ValueError with
more than one, since no global array spans processes here.

    python -m repro_torch.launch.train ...        # one process, one card
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _world() -> tuple:
    """(rank, world size) of an initialised process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator: str = "", num_processes: int = 0,
               process_id: int = -1) -> bool:
    """Initialise ``torch.distributed`` when running multi-process
    (``coordinator`` "host:port", else MASTER_ADDR:MASTER_PORT;
    ``num_processes``, else WORLD_SIZE; ``process_id``, else RANK); a
    no-op returning False in a single process."""
    if not coordinator and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "0"))
    if not coordinator or num_processes <= 1:
        return False
    process_id = process_id if process_id >= 0 else int(
        os.environ.get("RANK", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    return True


def host_batch_slice(global_batch: int):
    """(start, size) of this process's rows of the global batch, the batch
    split over processes in rank order."""
    idx, n = _world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} processes")
    per = global_batch // n
    return idx * per, per


def make_global_batch(batch_np: dict, mesh, rules, input_axes: dict):
    """This process's numpy rows -> tensors on the mesh's device
    (``input_axes``: leaf name -> logical axes, as ``Model.input_specs``
    gives them; checked against each leaf's rank).  One process only: the
    port runs on one card, and a batch spread over processes has no
    global tensor here (ValueError)."""
    _, n = _world()
    if n != 1:
        raise ValueError(f"make_global_batch: {n} processes; the port runs "
                         f"on one card and builds no global batch across "
                         f"processes")
    device = mesh.devices[0] if getattr(mesh, "devices", ()) else "cpu"
    out = {}
    for k, v in batch_np.items():
        v = np.asarray(v)
        rules.spec(v.shape, input_axes[k])       # rank and rules agree
        out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out
