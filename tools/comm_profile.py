#!/usr/bin/env python3
"""Where a training step's time goes under each transport of
``chip_smoke.py``'s 7a-comm phase, on one H100 (card only).

    python3 tools/comm_profile.py [steps]

For the f32 ring of ``ad_psgd`` and each of the five transports of
``chip_smoke.COMM_CONFIGS`` (the second here through ``setup_training``
with the same knobs, not the CLI), at full ``swb2000-blstm`` width on the
§V data (16 learners, batch 256, T = 21, var-len, seed 0): ``steps``
timed steps after one warm-up (median, min and max ms), the transport's
mixer alone on the final params (CUDA events over 10 eager calls after
2), and one more step under torch.profiler: the device's busy share of
its wall time and the kernels that take the most device time.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as C  # noqa: E402


def main() -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    from repro_torch.launch import train as TR

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    C.phase_device()
    C.phase_build()
    dev = torch.device("cuda")
    base = get_arch("swb2000-blstm")
    configs = [("ad_psgd-f32", "ad_psgd", {})] + C.COMM_CONFIGS
    for name, strategy, knobs in configs:
        tag = f"comm-profile {name}"
        cfg = dataclasses.replace(base, **knobs)
        state, step, meta = TR.setup_training(
            cfg, strategy_name=strategy, n_learners=C.TRAIN_L, seed=C.SEED,
            device=dev)
        ds = make_dataset(cfg, seq_len=C.TRAIN_T,
                          batch=C.TRAIN_L * C.TRAIN_B, seed=C.SEED,
                          var_len=True)
        state, _, rec = TR.run(state, step, ds, steps=1 + steps, device=dev)
        ms = [1e3 * r[0] for r in rec[1:]]
        mix = meta["transport"].make_mixer(C.TRAIN_L)
        comm = state.get("comm", {})
        mix_ms = C._time_ms(lambda: mix(state["params"], state["step"],
                                        comm), 10)
        print(f"[{tag}] {meta['transport']}: {steps} steps median "
              f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max "
              f"{max(ms):.2f}); the mixer alone {mix_ms:.2f} ms a round",
              flush=True)
        got = C._profile_window(
            lambda: TR.run(state, step, ds, steps=1, device=dev,
                           start=1 + steps), tag)
        if got is not None:
            (_, _, r1), _, busy_ms, rows = got
            wall_ms = 1e3 * r1[0][0]
            print(f"[{tag}] one step: wall {wall_ms:.1f} ms, device busy "
                  f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)",
                  flush=True)
            for us, n, key in rows[:8]:
                print(f"[{tag}]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:70]}",
                      flush=True)
        del state, step, meta, ds, comm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
