"""Training launcher — the port of ``repro.launch.train`` (main path).

Library entry point: :func:`setup_training` builds (state, step_fn, meta)
for any arch under one strategy; :func:`run` drives the loop
(prefetching, logging, per-step timing); the CLI wraps both.

    # the paper's §V setup on the card: AD-PSGD, 16 learners, batch 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch swb2000-blstm \\
        --learners 16 --batch 256 --var-len --steps 20 --log-every 1

    # a language model on the card: smollm-360m under its config's
    # ad_psgd over 16 learners, batch 32 x 128 tokens, 2 microbatches
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --batch 32 --steps 20 --log-every 1

    # any arch at reduced size on the CPU (the plain PyTorch path)
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --reduced --device cpu --steps 2 --log-every 1

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

    # fault-tolerant training: learner 0 straggles 4x, learner 1 crashes
    # at step 3 and rejoins at step 6, stale learners damped (λ = 0.2)
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --learners 4 --fault-stragglers 0:4 \\
        --fault-departures 1:3:6 --comm-staleness-lambda 0.2 --steps 8 \\
        --log-every 1

    # decentralized training across ranks: the learner axis split over
    # 2 CPU processes (gloo), or over 4 cards, one rank a card (nccl)
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --reduced --device cpu --learners 4 \\
        --var-len --steps 3 --log-every 1
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch swb2000-blstm --learners 16 \\
        --batch 256 --var-len --steps 20 --log-every 1

    # ... with an int8 wire in 4 MB buckets, or under a fault plan
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch swb2000-blstm --learners 16 \\
        --batch 256 --var-len --steps 20 --log-every 1 \\
        --strategy ad_psgd_q8 --comm-bucket-mb 4
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --reduced --device cpu --learners 4 \\
        --var-len --steps 8 --log-every 1 --fault-stragglers 0:4 \\
        --fault-departures 1:3:6 --comm-wire int8

``--ckpt-dir`` restores the latest checkpoint there at start, when one
exists, and the step count goes on from it; ``--ckpt-every`` saves every
that many steps; ``--resume`` requires a checkpoint (the optimizer state,
the wires' error-feedback state in ``state['comm']`` and the elastic
staleness counters resume bit for bit).  ``--steps`` counts the steps of
this run: a resumed run takes that many more from the restored step.
``--consensus`` logs the replicas' consensus distance each step.  The
``--comm-*`` flags override the strategy's transport
(``core/transport.py``).  Any of ``--fault-stragglers``,
``--fault-departures``, ``--fault-drop-prob``, ``--fault-stall-prob`` or
``--fault-corrupt-prob`` switches to the elastic step
(``core/strategies.make_elastic_train_step``) under one deterministic
``core/faults.FaultPlan``, whose inputs at the global step number drive
each step, so a resumed run sees the faults an uninterrupted one would.
Under ``torchrun`` (W processes, ``launch/multihost.initialize``) each
rank holds a contiguous block of L/W learners (ValueError unless W
divides L) on its card (``cuda:LOCAL_RANK`` over nccl; ranks that share a
card, or ``--device cpu``, over gloo), takes its rows of every global
batch, and the mixes cross ranks (``core/collective.py``); rank 0 prints
the header line with the backend and placement, the log, timing and
``final loss`` lines (the globally reduced metrics: a W = 4 run prints
W = 1's loss lines), writes ``--trace-out``, and saves the gathered
state, so a checkpoint resumes at any W that divides L.  Every
``--comm-*`` wire, bucketing and topology and the elastic step
(``--fault-*``) run across ranks with one process's bits: coded payloads
cross ranks coded, the fault plan's masks and the staleness counters are
global on every rank, and the elastic mix gathers each leaf's coded
payloads for one process's full product.  The checkpoint writes the
staleness counters, and a straddling H-ring's pod-domain EF state
(``--comm-pod-size`` not dividing L/W), once, as every rank holds them.
``--trace-out`` turns observability on (``repro_torch.obs``): every
step's metrics as a ``train/step`` event (the gradient norm included),
``train/fetch`` spans, the step's first-call and steady wall time
(``train/step``, timed up to a ``torch.cuda.synchronize``), the loss,
wire-byte, fault and padding instruments and the ``kernel/stash_bytes``
gauge, written as JSONL (``--trace-deterministic``: without the
wall-clock fields, byte-identical between two seeded runs).  ``--seq-len``
defaults to 21 frames for the lstm family and 128 positions otherwise
(an encdec batch splits them evenly between frames and tokens, a vlm
batch gives ``vlm_patch_frac`` of them to patches); ``--var-len`` and
``--bucket`` are the lstm family's alone.  ``--mesh local`` is the world
of ranks (one process: the one card), and ``pod``/``multipod`` (256 and
512 devices) raise, pointing to ``repro_torch.launch.dryrun``.  Three of
the reference's flags have no counterpart: ``--kernel-impl`` (the card
always runs the kernels and ``--device cpu`` their plain versions), and
``--block-b`` and ``--vmem-budget-mb``, which size TPU VMEM tiles.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_arch
from repro_torch.core import collective as C
from repro_torch.core import strategies as ST
from repro_torch.core.faults import (FaultPlan, parse_departures,
                                     parse_stragglers)
from repro_torch.data import Prefetcher, make_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import chunk_length, stash_bytes
from repro_torch.launch import multihost
from repro_torch.models import build_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import paper_recipe, warmup_then_anneal
from repro_torch.params import init_params


def setup_training(cfg, *, strategy_name: str = None, n_learners: int = None,
                   optimizer_name: str = "sgd", lr_schedule=None,
                   seed: int = 0, device=None, with_consensus: bool = False,
                   with_grad_norm: bool = False, elastic: bool = False,
                   fault_seed: int = 0, with_corruption: bool = False):
    """Build the train state and step for one arch of any family, through
    ``build_model(cfg)``'s ``param_specs`` and ``loss_fn``.

    Weights are drawn from ``seed`` (:func:`repro_torch.params.
    init_params`) and copied to every learner (under a process group,
    to this rank's block of them: every rank draws the same weights).
    ``device`` defaults to the CUDA card and raises without one;
    ``device="cpu"`` runs the plain PyTorch path.  The default schedule
    is the reference's (``repro/launch/train.py:71``); microbatches and
    the mixing transport come from ``cfg`` (its ``comm_*`` knobs).
    ``with_consensus`` and ``with_grad_norm`` add those metrics to every
    step.
    ``elastic=True`` builds the fault-tolerant step
    (``ST.make_elastic_train_step``, with ``fault_seed`` and
    ``with_corruption``) and its state (``ST.init_elastic_state``): the
    step takes a third argument, one ``FaultPlan.step_inputs`` dict.
    ``meta["loss_fn"]`` is the per-learner loss the step
    differentiates."""
    dev = resolve_device(device)
    model = build_model(cfg)
    strategy = ST.get_strategy(strategy_name or cfg.train_strategy)
    n_learners = n_learners if n_learners is not None else cfg.n_learners
    if not strategy.replicated:
        n_learners = 1
    transport = ST.transport_from_cfg(cfg, strategy)
    opt = get_optimizer(optimizer_name)
    lr_schedule = lr_schedule or warmup_then_anneal(0.1, 0.5, 100, 10_000,
                                                    1 / np.sqrt(2))

    loss_fn = model.loss_fn

    kw = dict(n_learners=n_learners, microbatches=cfg.microbatches,
              transport=transport, with_consensus=with_consensus,
              with_grad_norm=with_grad_norm)
    if elastic:
        step_fn = ST.make_elastic_train_step(
            strategy, loss_fn, opt, lr_schedule, fault_seed=fault_seed,
            with_corruption=with_corruption, **kw)
    else:
        step_fn = ST.make_train_step(strategy, loss_fn, opt, lr_schedule,
                                     **kw)
    params = init_params(model.param_specs(), seed, dev)
    if strategy.replicated:
        params = ST.stack_for_learners(params, n_learners)
    init = ST.init_elastic_state if elastic else ST.init_state
    state = init(strategy, params, opt, transport=transport)
    meta = dict(strategy=strategy, n_learners=n_learners,
                transport=transport, device=dev, loss_fn=loss_fn)
    return state, step_fn, meta


MESH_DEVICES = {"pod": 256, "multipod": 512}


def check_mesh(mesh: str) -> None:
    """``--mesh local`` (the local ranks: one process, or the cards of a
    ``torchrun`` launch) runs; the reference's pod meshes need 256 or 512
    devices, which one host has not: ValueError, naming the dry-run that
    accounts for them."""
    if mesh in MESH_DEVICES:
        raise ValueError(
            f"--mesh {mesh} lays the step over {MESH_DEVICES[mesh]} "
            f"devices; the port trains on the local cards (--mesh "
            f"local).  "
            f"python -m repro_torch.launch.dryrun --mesh {mesh} gives its "
            f"per-device bytes")
    if mesh != "local":
        raise ValueError(f"--mesh must be local, pod or multipod, got "
                         f"{mesh!r}")


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


def _positions(batch):
    """(valid, padded) positions of a batch: the utterances' frames (the
    valid ones counted from ``lengths``), else the tokens."""
    x = batch["features"] if "features" in batch else batch["tokens"]
    padded = int(x.shape[0] * x.shape[1])
    if "lengths" in batch:
        return int(batch["lengths"].sum()), padded
    return padded, padded


def _batch_key(args, kwargs):
    """The step's shape key: the batch's array shapes (args[1]); a new
    padded length is a first call again."""
    return tuple(sorted((k, tuple(v.shape)) for k, v in args[1].items()))


def _record_step(k: int, metrics, strategy: str, valid: int, padded: int):
    """One step's instruments (no-ops while observability is off): the
    ``train/step`` event with every metric as a float, the loss and
    gradient-norm histograms, bytes on the wire per strategy, the live
    learners and staleness, and the padding efficiency so far."""
    scal = {name: float(v) for name, v in metrics.items()}
    obs.event("train/step", step=k, **scal)
    obs.histogram("train/loss").observe(scal["loss"])
    if "grad_norm" in scal:
        obs.histogram("train/grad_norm").observe(scal["grad_norm"])
    if "wire_bytes" in scal:
        obs.counter("train/wire_bytes", strategy=strategy).inc(
            scal["wire_bytes"])
    if "n_active" in scal:
        obs.gauge("train/n_active").set(scal["n_active"])
        obs.histogram("train/staleness_max").observe(scal["staleness_max"])
    if padded:
        obs.gauge("train/pad_eff").set(valid / padded)


def save_state(ckpt_dir: str, step: int, state, *,
               replicated: bool = True, whole=("step",)) -> None:
    """``checkpoint.save`` of the train state; under a process group the
    learner-stacked leaves are gathered (to the host, a leaf at a time)
    but those under the keys in ``whole``, which every rank holds whole
    (``ST.whole_keys``), and rank 0 writes what one process writes, the
    others waiting for it."""
    rank, W = C.world()
    if W > 1 and replicated:
        state = {k: C.gather_tree(v, "cpu") if k not in whole else v
                 for k, v in state.items()}
    if rank == 0:
        save(ckpt_dir, step, state)
    if W > 1:
        torch.distributed.barrier()


def run(state, step_fn, dataset, *, steps: int, device, start: int = 0,
        log_every: int = 0, label: str = "", ckpt_dir: str = "",
        ckpt_every: int = 0, plan: FaultPlan = None, strategy: str = "",
        whole=("step",)):
    """Run ``steps`` steps, numbered from ``start``, on prefetched batches
    of ``dataset`` (the data is a pure function of the step number, so a
    run restored at ``start`` sees the batches an uninterrupted one would).
    With a fault ``plan`` the step is the elastic one: each step k gets
    ``plan.step_inputs(k)`` after :func:`ST.check_active`, and the log
    line the live count and the largest staleness.

    Prints the reference's ``step k loss ...`` line every ``log_every``
    steps (0 = never), and saves the state to ``ckpt_dir`` after every
    ``ckpt_every``-th step (0 = never; :func:`save_state`, ``whole`` the
    state's keys that are not split over ranks).  Each step is timed on the host clock between two
    ``torch.cuda.synchronize`` calls.  While observability is on, each
    step lands in the flight recorder (:func:`_record_step`, ``strategy``
    tagging the wire bytes) and the step is wrapped in a compile/steady
    :class:`~repro_torch.obs.ProfiledFn` (``train/step``).  Returns
    (state, metrics of the last step, per-step records (seconds, valid
    frames, padded frames, loss); an LM batch's frames are its tokens)."""
    pf = Prefetcher(dataset, start_step=start)
    records, metrics = [], None
    if obs.enabled():
        step_fn = obs.profiled(step_fn, "train/step", key=_batch_key,
                               metrics=obs.get_metrics(),
                               recorder=obs.get_recorder())
    valid_all = padded_all = 0          # over var-len batches only
    t0 = time.time()
    try:
        for k in range(start, start + steps):
            with obs.span("train/fetch", step=k):
                batch = pf.next()
            valid, padded = _positions(batch)
            if "lengths" in batch:
                valid_all += valid
                padded_all += padded
            _sync(device)
            ts = time.perf_counter()
            if plan is None:
                state, metrics = step_fn(state, batch)
            else:
                faults = plan.step_inputs(k)
                ST.check_active(faults["active"])
                state, metrics = step_fn(state, batch, faults)
            _sync(device)
            records.append((time.perf_counter() - ts, valid, padded,
                            metrics["loss"]))
            if obs.enabled():
                _record_step(k, metrics, strategy, valid_all, padded_all)
            if log_every and k % log_every == 0:
                loss = float(metrics["loss"])
                line = f"step {k:5d} loss {loss:.4f} ({time.time() - t0:.1f}s)"
                if padded_all:
                    line += f" pad_eff {valid_all / padded_all:.2f}"
                if "wire_bytes" in metrics:
                    line += f" wire {float(metrics['wire_bytes']) / 2**20:.2f}MB"
                if "n_active" in metrics:
                    line += (f" act {int(metrics['n_active'])}/"
                             f"{plan.n_learners} stale "
                             f"{metrics['staleness_max']}")
                if "consensus" in metrics:
                    line += f" consensus {float(metrics['consensus']):.3e}"
                if "grad_norm" in metrics:
                    line += f" grad_norm {float(metrics['grad_norm']):.4g}"
                print(label + line, flush=True)
            if ckpt_dir and ckpt_every and (k + 1) % ckpt_every == 0:
                known = ST.STRATEGIES.get(strategy)
                save_state(ckpt_dir, k + 1, state,
                           replicated=known is None or known.replicated,
                           whole=whole)
    finally:
        pf.close()
    return state, metrics, records


def timing_line(records, unit: str = "valid frames") -> str:
    """First-step vs steady time: the first step also builds kernels and
    warms allocators, so it is reported apart.  ``unit`` names what the
    records count (an LM's tokens)."""
    first = records[0][0]
    steady = records[1:]
    line = f"timing: first step {1e3 * first:.1f} ms"
    if steady:
        secs = sum(r[0] for r in steady)
        frames = sum(r[1] for r in steady)
        line += (f", steady {1e3 * secs / len(steady):.1f} ms/step over "
                 f"{len(steady)} steps, {frames / secs:.1f} {unit}/s")
    return line


def main(argv=None):
    """The CLI; returns the final ``state``, the last step's ``metrics``,
    the per-step ``records`` of :func:`run` and ``meta``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="swb2000-blstm",
                    help="any registered arch (repro_torch.configs)")
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
                         "padded frames (lstm family only)")
    ap.add_argument("--bucket", action="store_true",
                    help="length-bucketed batching (implies --var-len; "
                         "lstm family only)")
    ap.add_argument("--consensus", action="store_true",
                    help="log the replicas' consensus distance each step")
    ap.add_argument("--grad-norm", action="store_true",
                    help="log the applied gradient's L2 norm each step "
                         "(--trace-out records it too)")
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
    ap.add_argument("--comm-staleness-lambda", type=float, default=0.0,
                    help="elastic mixing: staleness damping λ — a "
                         "learner s steps behind mixes with confidence "
                         "1/(1 + λ·s); 0 = cfg value")
    ap.add_argument("--fault-stragglers", default="",
                    help="fault plan: 'learner:factor,...' — e.g. '0:4' "
                         "makes learner 0 contribute a gradient only "
                         "every 4th step; any --fault-* flag switches to "
                         "the elastic fault-tolerant step")
    ap.add_argument("--fault-departures", default="",
                    help="fault plan: 'learner:step[:rejoin],...' — "
                         "e.g. '1:30:60' crashes learner 1 at step 30 "
                         "and rejoins it (re-seeded from the survivors' "
                         "consensus) at step 60")
    ap.add_argument("--fault-drop-prob", type=float, default=0.0,
                    help="fault plan: per-step probability that an "
                         "undirected gossip edge drops (both endpoints "
                         "fall back to themselves)")
    ap.add_argument("--fault-stall-prob", type=float, default=0.0,
                    help="fault plan: per-step probability a learner "
                         "enters a heavy-tailed (Pareto) stall")
    ap.add_argument("--fault-corrupt-prob", type=float, default=0.0,
                    help="fault plan: per-step probability a learner's "
                         "outgoing payload picks up noise (receivers "
                         "only; needs --fault-corrupt-scale > 0)")
    ap.add_argument("--fault-corrupt-scale", type=float, default=0.0,
                    help="fault plan: corruption noise RMS relative to "
                         "the payload RMS")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault plan: seed of the deterministic fault "
                         "schedule (same seed = same cluster weather)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="require and restore the latest checkpoint in "
                         "--ckpt-dir; fails if nothing to resume")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); "
                         "'cpu' runs the plain PyTorch path")
    ap.add_argument("--trace-out", default="",
                    help="enable observability and write the run's "
                         "flight-recorder JSONL here (render with "
                         "repro_torch.launch.obsreport); also records the "
                         "per-step gradient norm")
    ap.add_argument("--trace-deterministic", action="store_true",
                    help="strip wall-clock fields from the JSONL so "
                         "two seeded runs emit byte-identical traces")
    ap.add_argument("--mesh", default="local",
                    choices=("local", "pod", "multipod"),
                    help="local: the local ranks (one process: the one "
                         "card; under torchrun one rank a card); pod (256 "
                         "devices) and multipod (512) are the reference's "
                         "TPU meshes, which the port only accounts for "
                         "(repro_torch.launch.dryrun --mesh pod)")
    args = ap.parse_args(argv)
    check_mesh(args.mesh)

    multihost.initialize(device=args.device)
    place = multihost.placement()
    rank, world = C.world()
    say = print if rank == 0 else _quiet
    device = place.device if place else resolve_device(args.device)
    if args.trace_out and rank == 0:
        obs.configure()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    changes = {}
    if args.stash_dtype:
        changes["lstm_stash_dtype"] = args.stash_dtype
    if args.seq_chunk:
        changes["lstm_seq_chunk"] = args.seq_chunk
    for key in ("comm_topology", "comm_wire", "comm_intra_wire",
                "comm_bucket_mb", "comm_pod_size", "comm_topk_frac",
                "comm_staleness_lambda"):
        if getattr(args, key):
            changes[key] = getattr(args, key)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    lstm = cfg.family == "lstm"
    seq_len = args.seq_len or (21 if lstm else 128)
    n_learners = (args.learners if args.learners is not None
                  else cfg.n_learners)
    strategy = ST.get_strategy(args.strategy or cfg.train_strategy)
    if not strategy.replicated:
        n_learners = 1
    batch = args.batch or max(8, 2 * n_learners)
    if world > 1:
        if strategy.replicated:
            C.learner_block(n_learners)      # ValueError unless W | L
        multihost.host_batch_slice(batch)    # ValueError unless W | B
        say(f"world: {world} ranks over {place.backend}, {n_learners} "
            f"learners ({n_learners // world if strategy.replicated else 1}"
            f" a rank); {place.describe()}", flush=True)

    # any --fault-* flag switches to the elastic step under one
    # deterministic fault plan
    plan = None
    if (args.fault_stragglers or args.fault_departures
            or args.fault_drop_prob or args.fault_stall_prob
            or args.fault_corrupt_prob):
        plan = FaultPlan(
            n_learners, seed=args.fault_seed,
            stragglers=parse_stragglers(args.fault_stragglers),
            departures=parse_departures(args.fault_departures),
            drop_prob=args.fault_drop_prob,
            stall_prob=args.fault_stall_prob,
            corrupt_prob=args.fault_corrupt_prob,
            corrupt_scale=args.fault_corrupt_scale)
        say(plan.describe(), flush=True)

    state, step_fn, meta = setup_training(
        cfg, strategy_name=strategy.name, n_learners=n_learners,
        optimizer_name=args.optimizer, seed=args.seed, device=device,
        with_consensus=args.consensus,
        with_grad_norm=args.grad_norm or bool(args.trace_out),
        lr_schedule=paper_recipe(steps_per_epoch=max(args.steps // 16, 1),
                                 base_lr=0.05, peak_lr=0.2),
        elastic=plan is not None, fault_seed=args.fault_seed,
        with_corruption=args.fault_corrupt_prob > 0)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    start = 0
    whole = (ST.whole_keys(state, meta["transport"]) if strategy.replicated
             else ("step",))
    if args.ckpt_dir:
        block = None
        if world > 1 and strategy.replicated:
            block = (*C.learner_block(n_learners), n_learners)
        try:
            state, start = restore(args.ckpt_dir, state,
                                   learner_block=block, whole=whole)
            say(f"restored checkpoint at step {start}")
        except FileNotFoundError:
            if args.resume:
                raise SystemExit(
                    f"--resume: no checkpoint under {args.ckpt_dir}")
    ds = make_dataset(cfg, seq_len=seq_len, batch=batch, seed=args.seed,
                      var_len=args.var_len or args.bucket,
                      bucket=args.bucket)
    if lstm:
        say(stash_line(cfg, batch, seq_len), flush=True)
    if lstm and obs.enabled():
        # the stash of one learner's share of the batch, at the
        # per-direction width and the resolved chunk length
        itemsize = 2 if cfg.lstm_stash_dtype == "bfloat16" else 4
        K = (chunk_length(seq_len, cfg.lstm_seq_chunk)
             if cfg.lstm_seq_chunk else 0)
        obs.gauge("kernel/stash_bytes", seq_chunk=K).set(stash_bytes(
            max(batch // max(n_learners, 1), 1), seq_len, cfg.lstm_hidden,
            n_dir=2, stash_itemsize=itemsize, seq_chunk=K))
    t0 = time.time()
    # hand the state over: with no reference left here, each step frees
    # the state it replaces (at full width, replicas of gigabytes)
    box = [state]
    del state
    state, metrics, records = run(box.pop(), step_fn, ds, steps=args.steps,
                                  device=device, start=start,
                                  log_every=args.log_every if rank == 0
                                  else 0,
                                  ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every, plan=plan,
                                  strategy=meta["strategy"].name,
                                  whole=whole)
    if metrics is not None:
        say(f"final loss {float(metrics['loss']):.6f}")
    say(f"done: {args.steps} steps in {time.time() - t0:.1f}s "
        f"[{meta['strategy'].name}, L={meta['n_learners']}, {device}]")
    if records:
        say(timing_line(records, "valid frames" if lstm else "tokens"),
            flush=True)
    if args.trace_out and rank == 0:
        n = obs.dump(args.trace_out,
                     deterministic=args.trace_deterministic)
        print(f"trace: {n} events -> {args.trace_out}")
        obs.reset()
    meta["plan"] = plan
    return dict(state=state, metrics=metrics, records=records, meta=meta)


def _quiet(*args, **kwargs):
    """The print of a rank other than 0: rank 0 speaks for the run."""


if __name__ == "__main__":
    main()
