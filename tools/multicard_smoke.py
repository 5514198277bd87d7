#!/usr/bin/env python3
"""Decentralized training across the local cards over NCCL, one rank a
card (needs two or more H100s).

    python3 tools/multicard_smoke.py

The learner axis of the paper's §V step at full ``swb2000-blstm`` width
(16 learners, batch 256, T = 21, var-len, seed 0) split over every card
of the machine: ``chip_smoke.phase_multirank`` with the nccl backend,
rank k on ``cuda:k``, payloads card to card — ad_psgd for 3 steps,
hring with one pod a rank and sc_psgd_replicated for 2 each, ad_psgd_q8
with 4 MB buckets and hring over bf16 intra-pod and top-k inter-pod
wires for 3 each, the elastic step under 7a-elastic's plans (a) for 7
steps and (b) for 4; every state leaf, every loss and the last step's
metrics held bit for bit against the same steps in one process on
cuda:0, whose ad_psgd losses equal the train phase's.  Then the train
CLI as a user launches it, under ``torchrun --standalone`` with one rank
a card, plain, with ``--comm-wire int8 --comm-bucket-mb 4`` and with
``--fault-departures``, whose loss lines must equal the one-process
CLI's.  Prints ms/step at W = 1 and W = the card count, the exchange
alone and the bytes each rank sends a step beside the analytic wire
bytes, beside the cards' names and power limits.  The last line is ``{"ok": true,
...}``; a rank that raises, a machine with fewer than two cards or any
difference fails the run (nonzero exit).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as C  # noqa: E402


CLI = ["-m", "repro_torch.launch.train", "--arch", "swb2000-blstm",
       "--learners", str(C.TRAIN_L), "--batch", str(C.TRAIN_L * C.TRAIN_B),
       "--var-len", "--log-every", "1"]
# name -> the CLI's extra flags: plain, a coded wire in buckets, faults
CLI_RUNS = {
    "plain": ["--steps", "3"],
    "int8": ["--steps", "3", "--comm-wire", "int8", "--comm-bucket-mb", "4"],
    "faults": ["--steps", "4", "--fault-stragglers", "0:2",
               "--fault-departures", "1:1:3", "--comm-wire", "int8"],
}
CLI_S = 300               # the most one CLI run may take


def _loss_lines(text: str) -> list:
    return [line.split(" (")[0] for line in text.splitlines()
            if line.startswith(("step ", "final loss"))]


def phase_torchrun_cli(cards: int) -> None:
    """The train CLI in one process and under ``torchrun --standalone
    --nproc-per-node cards`` (``launch/multihost.initialize`` from the
    launcher's environment: nccl, rank k on cuda:k), for each of
    :data:`CLI_RUNS`: the same loss lines, and the ranks' header naming
    nccl."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    for name, flags in CLI_RUNS.items():
        runs = {}
        for W, head in ((1, []), (cards, ["-m", "torch.distributed.run",
                                          "--standalone", "--nproc-per-node",
                                          str(cards)])):
            argv = [sys.executable] + head + CLI + flags
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=HERE, env=env,
                                  capture_output=True, text=True,
                                  timeout=CLI_S)
            if proc.returncode:
                C._fail(f"[multicard] the {name} CLI at W = {W} exited "
                        f"{proc.returncode}: {proc.stdout[-2000:]}"
                        f"{proc.stderr[-2000:]}")
            runs[W] = proc.stdout
            timing = [line for line in proc.stdout.splitlines()
                      if line.startswith("timing:")]
            print(f"[multicard] {name} CLI at W = {W}: "
                  f"{_loss_lines(proc.stdout)}; {timing}; "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        header = f"world: {cards} ranks over nccl"
        if header not in runs[cards]:
            C._fail(f"[multicard] the torchrun {name} CLI printed no "
                    f"{header!r}")
        if not _loss_lines(runs[1]) or \
                _loss_lines(runs[1]) != _loss_lines(runs[cards]):
            C._fail(f"[multicard] the torchrun {name} CLI's loss lines "
                    f"differ from one process's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        C._fail("torch.cuda.is_available() is false")
    cards = torch.cuda.device_count()
    if cards < 2:
        C._fail(f"{cards} CUDA card: NCCL across cards needs two or more")
    if C.TRAIN_L % cards:
        C._fail(f"{C.TRAIN_L} learners do not split over {cards} cards")
    t0 = time.perf_counter()
    C.phase_device()
    C.phase_build()
    state, step, ds, counts, steps, ms, losses = C.phase_train()
    del state, step, ds
    torch.cuda.empty_cache()
    launches = C.phase_multirank(losses, backend="nccl", world=cards)
    torch.cuda.empty_cache()
    phase_torchrun_cli(cards)
    print(f"[multicard] {cards} ranks over nccl, K1-stash and K2 launches "
          f"by the ranks {launches}; {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
