"""Learning-rate schedules — the port of ``repro.optim.schedules``.

``paper_recipe`` reproduces §V of the paper: distributed runs start at
the single-GPU base LR (0.1) and *linearly warm up* to the large-batch LR
over the first 10 epochs, then anneal by 1/sqrt(2) every epoch.  Every
schedule is computed in float32, op for op as the reference computes it,
so the learning rates equal the reference's bit for bit; they return a
0-d float32 tensor on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def warmup_then_anneal(base_lr: float, peak_lr: float, warmup_steps: int,
                       anneal_every: int, anneal_factor: float):
    def sched(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr + (peak_lr - base_lr) * torch.clamp(
            step / max(warmup_steps, 1), max=1.0)
        n_anneals = torch.floor(
            torch.clamp(step - warmup_steps, min=0.0) / max(anneal_every, 1))
        return warm * torch.pow(torch.tensor(anneal_factor, dtype=_F32),
                                n_anneals)

    return sched


def paper_recipe(steps_per_epoch: int, base_lr: float = 0.1,
                 peak_lr: float = 1.0):
    """§V: warm up linearly from 0.1 to 1.0 over 10 epochs, then multiply
    by 1/sqrt(2) each epoch."""
    return warmup_then_anneal(
        base_lr, peak_lr,
        warmup_steps=10 * steps_per_epoch,
        anneal_every=steps_per_epoch,
        anneal_factor=float(1.0 / np.sqrt(2.0)),
    )
