"""Device resolution, the Hopper capability probe and the kernels'
autograd guard.

Entry points take ``device=None`` and resolve it here: ``None`` means the
CUDA card, and raises when there is none, so a run never carries on
quietly on the CPU.  ``device="cpu"`` is the explicit request for the
plain PyTorch path (the CPU tests use it).

Every kernel wrapper asks :func:`plain_path` which side to take: the
hand-written kernel on a CUDA tensor, its plain version on a CPU tensor
and on a fake tensor (the dry-run's stand-ins, ``launch/dryrun.py``,
which hold no data a kernel could read).  The reference's
``kernel_impl`` switch has no counterpart: nothing runs a plain version
on the card's tensors.  A kernel launches on its tensor's card, whatever
its index (:func:`on_card`): under ``torchrun`` each rank's tensors live
on ``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor


def plain_path(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper runs its plain version on ``t``: a CPU
    tensor or a fake one.  A tensor on any other device takes the kernel
    path, whose device checks raise off the card."""
    return t.device.type == "cpu" or isinstance(t, FakeTensor)


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
    if t.get_device() in _CAPABLE:     # a card checked before (-1 off
        return                         # the card): no device object built
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {dev}")
    index = t.get_device()
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a; device {dev} has "
            f"capability {cap}")
    _CAPABLE.add(index)


_SAME = contextlib.nullcontext()


def on_card(t: torch.Tensor):
    """The context of a ctypes launch on ``t``'s card: the kernel
    libraries launch on the current device of the calling thread (their
    runtime takes the context PyTorch made current), so a tensor on
    another card than the current one makes its card current for the
    launch (``torch.cuda.device``) and restores the caller's after.  On
    the current card, a shared no-op context."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return _SAME
    return torch.cuda.device(index)


def wants_grad(*tensors) -> bool:
    """Grad mode is on and an input requires a gradient: a kernel wrapper
    then takes its autograd Function instead of the raw launch."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_no_grad(name: str, *tensors) -> None:
    """Raise where a raw launch would take an input that requires a
    gradient under grad mode: its output (filled by the kernel through a
    pointer) would carry no ``grad_fn``, and every gradient upstream of it
    would stop without a word."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: the raw launch takes no input that "
                           f"requires a gradient; call the wrapper, whose "
                           f"autograd Function differentiates it")
