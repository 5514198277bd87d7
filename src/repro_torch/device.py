"""Device resolution and the Hopper capability probe.

Entry points take ``device=None`` and resolve it here: ``None`` means the
CUDA card, and raises when there is none, so a run never carries on
quietly on the CPU.  ``device="cpu"`` is the explicit request for the
plain PyTorch path (the CPU tests use it).
"""
from __future__ import annotations

import torch

KERNEL_CAPABILITY = (9, 0)      # the kernels are compiled for sm_90a only


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_CAPABLE: set = set()    # device indices whose capability was checked


def require_kernel_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device of capability (9, 0); the
    capability is read once per device index."""
    if t.get_device() in _CAPABLE:     # cuda:0 (-1 off the card), checked
        return                         # before: no device object built
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {dev}")
    index = dev.index or 0
    if index != 0:
        # the ctypes libraries launch on their own runtime's current
        # device, which is device 0
        raise ValueError(f"the kernels launch on cuda:0, got {dev}")
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a; device {dev} has "
            f"capability {cap}")
    _CAPABLE.add(index)
