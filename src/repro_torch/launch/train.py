"""Training launcher — the port of ``repro.launch.train`` (main path).

Library entry point: :func:`setup_training` builds (state, step_fn, meta)
for the paper's acoustic model under one strategy; :func:`run` drives the
loop (prefetching, logging, per-step timing); the CLI wraps both.

    # the paper's §V setup on the card: AD-PSGD, 16 learners, batch 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch swb2000-blstm \\
        --learners 16 --batch 256 --var-len --steps 20 --log-every 1

    # long utterances: sequence-chunked recompute (K = 256 at T = 2000)
    PYTHONPATH=src python -m repro_torch.launch.train --arch swb2000-blstm \\
        --learners 16 --batch 32 --seq-len 2000 --var-len --seq-chunk -1 \\
        --steps 4 --log-every 1

    # the plain PyTorch path on the CPU, reduced size, with checkpoints
    # in a fresh directory (a checkpoint found there is restored)
    CK=$(mktemp -d)
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --ckpt-dir "$CK" --ckpt-every 2

    # the paper's §V hierarchical ring with compressed wires: bf16 inside
    # pods of 2, top-k error-feedback gossip across them, 1 MB buckets
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --learners 4 --strategy hring --comm-pod-size 2 \\
        --comm-intra-wire bf16 --comm-wire topk --comm-bucket-mb 1 \\
        --consensus --steps 3 --log-every 1

``--ckpt-dir`` restores the latest checkpoint there at start, when one
exists, and the step count goes on from it; ``--ckpt-every`` saves every
that many steps; ``--resume`` requires a checkpoint (the optimizer state
and the wires' error-feedback state in ``state['comm']`` resume bit for
bit).  ``--consensus`` logs the replicas' consensus distance each step.
The ``--comm-*`` flags override the strategy's transport
(``core/transport.py``).  Not ported yet (ROADMAP.md queue 1): fault
plans, the elastic step and ``--comm-staleness-lambda``, and
``--trace-out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_arch
from repro_torch.core import strategies as ST
from repro_torch.data import Prefetcher, make_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import chunk_length, stash_bytes
from repro_torch.models import lstm as LS
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import paper_recipe, warmup_then_anneal
from repro_torch.params import init_params


def setup_training(cfg, *, strategy_name: str = None, n_learners: int = None,
                   optimizer_name: str = "sgd", lr_schedule=None,
                   seed: int = 0, device=None, with_consensus: bool = False,
                   with_grad_norm: bool = False):
    """Build the train state and step for one arch.

    Weights are drawn from ``seed`` (:func:`repro_torch.params.
    init_params`) and copied to every learner.  ``device`` defaults to
    the CUDA card and raises without one; ``device="cpu"`` runs the plain
    PyTorch path.  The default schedule is the reference's
    (``repro/launch/train.py:71``); microbatches and the mixing
    transport come from ``cfg`` (its ``comm_*`` knobs).  ``with_consensus``
    and ``with_grad_norm`` add those metrics to every step.
    ``meta["loss_fn"]`` is the per-learner loss the step
    differentiates."""
    dev = resolve_device(device)
    if cfg.family != "lstm":
        raise ValueError(f"only the lstm family is ported, not "
                         f"{cfg.family!r}")
    strategy = ST.get_strategy(strategy_name or cfg.train_strategy)
    n_learners = n_learners if n_learners is not None else cfg.n_learners
    if not strategy.replicated:
        n_learners = 1
    transport = ST.transport_from_cfg(cfg, strategy)
    opt = get_optimizer(optimizer_name)
    lr_schedule = lr_schedule or warmup_then_anneal(0.1, 0.5, 100, 10_000,
                                                    1 / np.sqrt(2))

    def loss_fn(params, batch):
        return LS.loss_train(cfg, params, batch, device=dev)

    step_fn = ST.make_train_step(
        strategy, loss_fn, opt, lr_schedule, n_learners=n_learners,
        microbatches=cfg.microbatches, transport=transport,
        with_consensus=with_consensus, with_grad_norm=with_grad_norm)
    params = init_params(LS.param_specs(cfg), seed, dev)
    if strategy.replicated:
        params = ST.stack_for_learners(params, n_learners)
    state = ST.init_state(strategy, params, opt, transport=transport)
    meta = dict(strategy=strategy, n_learners=n_learners,
                transport=transport, device=dev, loss_fn=loss_fn)
    return state, step_fn, meta


def stash_line(cfg, batch: int, seq_len: int) -> str:
    """The residual stash of one training forward over the global batch:
    the resolved chunk length and the bytes per BLSTM layer from
    :func:`~repro_torch.kernels.lstm_cell.stash_bytes` (the reference's
    ``kernel/stash_bytes`` gauge, ``repro/launch/train.py:318-327``,
    taken at the per-direction width and the resolved K), beside what the
    per-step stash would hold."""
    itemsize = 2 if cfg.lstm_stash_dtype == "bfloat16" else 4
    kw = dict(n_dir=2, stash_itemsize=itemsize)
    full = stash_bytes(batch, seq_len, cfg.lstm_hidden, **kw)
    if not cfg.lstm_seq_chunk:
        return (f"stash: per-step ({cfg.lstm_stash_dtype}), {full} B per "
                f"layer, {cfg.n_layers * full / 2**20:.2f} MiB over "
                f"{cfg.n_layers} layers")
    K = chunk_length(seq_len, cfg.lstm_seq_chunk)
    per = stash_bytes(batch, seq_len, cfg.lstm_hidden, seq_chunk=K, **kw)
    return (f"stash: seq_chunk K={K} (T={seq_len}, T_pad="
            f"{-(-seq_len // K) * K}, {cfg.lstm_stash_dtype} entry "
            f"carries), {per} B per layer, "
            f"{cfg.n_layers * per / 2**20:.2f} MiB over {cfg.n_layers} "
            f"layers (per-step stash: {cfg.n_layers * full / 2**20:.2f} MiB)")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(state, step_fn, dataset, *, steps: int, device, start: int = 0,
        log_every: int = 0, label: str = "", ckpt_dir: str = "",
        ckpt_every: int = 0):
    """Run ``steps`` steps, numbered from ``start``, on prefetched batches
    of ``dataset`` (the data is a pure function of the step number, so a
    run restored at ``start`` sees the batches an uninterrupted one would).

    Prints the reference's ``step k loss ...`` line every ``log_every``
    steps (0 = never), and saves the state to ``ckpt_dir`` after every
    ``ckpt_every``-th step (0 = never).  Each step is timed on the host clock between two
    ``torch.cuda.synchronize`` calls.  Returns (state, metrics of the
    last step, per-step records (seconds, valid frames, padded frames,
    loss))."""
    pf = Prefetcher(dataset, start_step=start)
    records, metrics = [], None
    t0 = time.time()
    try:
        for k in range(start, start + steps):
            batch = pf.next()
            feats = batch["features"]
            padded = int(feats.shape[0] * feats.shape[1])
            valid = int(batch["lengths"].sum()) if "lengths" in batch \
                else padded
            _sync(device)
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(device)
            records.append((time.perf_counter() - ts, valid, padded,
                            metrics["loss"]))
            if log_every and k % log_every == 0:
                loss = float(metrics["loss"])
                line = f"step {k:5d} loss {loss:.4f} ({time.time() - t0:.1f}s)"
                if "lengths" in batch:
                    v = sum(r[1] for r in records)
                    p = sum(r[2] for r in records)
                    line += f" pad_eff {v / p:.2f}"
                if "wire_bytes" in metrics:
                    line += f" wire {float(metrics['wire_bytes']) / 2**20:.2f}MB"
                if "consensus" in metrics:
                    line += f" consensus {float(metrics['consensus']):.3e}"
                if "grad_norm" in metrics:
                    line += f" grad_norm {float(metrics['grad_norm']):.4g}"
                print(label + line, flush=True)
            if ckpt_dir and ckpt_every and (k + 1) % ckpt_every == 0:
                save(ckpt_dir, k + 1, state)
    finally:
        pf.close()
    return state, metrics, records


def timing_line(records) -> str:
    """First-step vs steady time: the first step also builds kernels and
    warms allocators, so it is reported apart."""
    first = records[0][0]
    steady = records[1:]
    line = f"timing: first step {1e3 * first:.1f} ms"
    if steady:
        secs = sum(r[0] for r in steady)
        frames = sum(r[1] for r in steady)
        line += (f", steady {1e3 * secs / len(steady):.1f} ms/step over "
                 f"{len(steady)} steps, {frames / secs:.1f} valid frames/s")
    return line


def main(argv=None):
    """The CLI; returns the final ``state``, the last step's ``metrics``,
    the per-step ``records`` of :func:`run` and ``meta``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="swb2000-blstm")
    ap.add_argument("--strategy", default=None,
                    choices=[None] + sorted(ST.STRATEGIES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--learners", type=int, default=None)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch (CPU-friendly)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stash-dtype", default="",
                    choices=["", "float32", "bfloat16"],
                    help="BLSTM residual-stash dtype (bfloat16 halves the "
                         "gate/cell stash)")
    ap.add_argument("--seq-chunk", type=int, default=0,
                    help="sequence-chunked recompute for long utterances: "
                         "K > 0 frames per chunk (clamped to T), -1 = auto "
                         "(min(256, next pow2 of T), halved while padding "
                         "exceeds T/8); the training forward then stashes "
                         "only the chunk-entry (h, c) carries and the "
                         "backward re-runs each chunk (0 = per-step "
                         "stash)")
    ap.add_argument("--var-len", action="store_true",
                    help="variable-length utterances: batches carry a "
                         "'lengths' key, loss/BLSTM/aggregation mask "
                         "padded frames")
    ap.add_argument("--bucket", action="store_true",
                    help="length-bucketed batching (implies --var-len)")
    ap.add_argument("--consensus", action="store_true",
                    help="log the replicas' consensus distance each step")
    ap.add_argument("--grad-norm", action="store_true",
                    help="log the applied gradient's L2 norm each step "
                         "(the reference records it under --trace-out, "
                         "not ported yet)")
    ap.add_argument("--comm-topology", default="",
                    choices=["", "uniform", "ring", "hierarchical", "exp",
                             "none"],
                    help="mixing topology override (default: the "
                         "strategy's own)")
    ap.add_argument("--comm-wire", default="",
                    choices=["", "f32", "bf16", "int8", "topk"],
                    help="wire codec of the mixing payloads (default: the "
                         "strategy's own, f32 but for ad_psgd_q8)")
    ap.add_argument("--comm-intra-wire", default="",
                    choices=["", "f32", "bf16", "int8"],
                    help="hierarchical topology: codec of the intra-pod "
                         "allreduce (the inter-pod ring uses --comm-wire; "
                         "topk is gossip-only and not valid here)")
    ap.add_argument("--comm-bucket-mb", type=int, default=0,
                    help="split mixing payloads into buckets of this many "
                         "MB, each coded on its own (0 = one payload per "
                         "tensor)")
    ap.add_argument("--comm-pod-size", type=int, default=0,
                    help="hierarchical topology: learners per pod (0 = "
                         "cfg value)")
    ap.add_argument("--comm-topk-frac", type=float, default=0.0,
                    help="topk wire: fraction of entries shipped (0 = "
                         "cfg value, 0.01)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="require and restore the latest checkpoint in "
                         "--ckpt-dir; fails if nothing to resume")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); "
                         "'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    changes = {}
    if args.stash_dtype:
        changes["lstm_stash_dtype"] = args.stash_dtype
    if args.seq_chunk:
        changes["lstm_seq_chunk"] = args.seq_chunk
    for key in ("comm_topology", "comm_wire", "comm_intra_wire",
                "comm_bucket_mb", "comm_pod_size", "comm_topk_frac"):
        if getattr(args, key):
            changes[key] = getattr(args, key)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    seq_len = args.seq_len or 21
    n_learners = (args.learners if args.learners is not None
                  else cfg.n_learners)
    strategy = ST.get_strategy(args.strategy or cfg.train_strategy)
    if not strategy.replicated:
        n_learners = 1
    batch = args.batch or max(8, 2 * n_learners)

    state, step_fn, meta = setup_training(
        cfg, strategy_name=strategy.name, n_learners=n_learners,
        optimizer_name=args.optimizer, seed=args.seed, device=device,
        with_consensus=args.consensus, with_grad_norm=args.grad_norm,
        lr_schedule=paper_recipe(steps_per_epoch=max(args.steps // 16, 1),
                                 base_lr=0.05, peak_lr=0.2))
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    start = 0
    if args.ckpt_dir:
        try:
            state, start = restore(args.ckpt_dir, state)
            print(f"restored checkpoint at step {start}")
        except FileNotFoundError:
            if args.resume:
                raise SystemExit(
                    f"--resume: no checkpoint under {args.ckpt_dir}")
    print(stash_line(cfg, batch, seq_len), flush=True)
    ds = make_dataset(cfg, seq_len=seq_len, batch=batch, seed=args.seed,
                      var_len=args.var_len or args.bucket,
                      bucket=args.bucket)
    t0 = time.time()
    state, metrics, records = run(state, step_fn, ds, steps=args.steps,
                                  device=device, start=start,
                                  log_every=args.log_every,
                                  ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every)
    if metrics is not None:
        print(f"final loss {float(metrics['loss']):.6f}")
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s "
          f"[{meta['strategy'].name}, L={meta['n_learners']}, {device}]")
    if records:
        print(timing_line(records), flush=True)
    return dict(state=state, metrics=metrics, records=records, meta=meta)


if __name__ == "__main__":
    main()
