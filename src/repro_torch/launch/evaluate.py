"""Recognition-quality evaluation launcher: checkpoint -> TER/FER table —
the port of ``repro.launch.evaluate``.

It restores a training checkpoint written by ``repro_torch.launch.train``
(same strategy, learners and optimizer, so the state tree matches),
averages the learner replicas to the consensus model, runs the BLSTM
forward over a held-out synthetic set (the ``lengths`` batch contract)
and scores it with

* **FER** — masked frame error rate (padding excluded),
* **TER** — token error rate (the WER formula) of greedy best-path and
  of the CTC prefix beam search (``repro_torch.decode``),
* throughput — valid frames/s through forward + decode, decoded
  tokens/s and beam occupancy, as the serve CLI counts them.

On the card the forward is one launch of the fused BLSTM-stack kernel
K4 per batch and the decode one launch of the beam kernel K5 per frame.
The output is the ``name,value,derived`` CSV of the reference.

    # the plain PyTorch path on the CPU, reduced size, in a fresh
    # directory (the train CLI restores any checkpoint it finds there)
    CK=$(mktemp -d)
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --ckpt-dir "$CK" --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.evaluate \\
        --arch swb2000-blstm --reduced --device cpu --ckpt-dir "$CK"

    # full width on the card: a 16-learner ad_psgd checkpoint
    CK=$(mktemp -d)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch swb2000-blstm --strategy ad_psgd --learners 16 --batch 256 \\
        --var-len --steps 2 --ckpt-dir "$CK" --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.evaluate \\
        --arch swb2000-blstm --strategy ad_psgd --learners 16 \\
        --ckpt-dir "$CK" --batches 4 --batch 8 --seq-len 256 --var-len \\
        --beam-width 8 --decode-chunk 8

``--trace-out`` writes the run's flight recorder as JSONL: each timed
batch's forward and decode as ``eval/fwd`` / ``eval/decode`` wall spans
and histograms (host time, each ending in ``torch.cuda.synchronize``);
``--trace-deterministic`` drops them, as it drops every wall-clock field.
Not ported yet (ROADMAP.md queue 1): ``--kernel-impl`` (the card always
runs the kernels; ``--device cpu`` the plain path).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import decode as DC
from repro_torch import obs
from repro_torch.checkpoint import restore
from repro_torch.configs import get_arch
from repro_torch.core import strategies as ST
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import (collapse_labels, frame_error_rate,
                                      greedy_ctc_decode, token_error_rate)
from repro_torch.launch.train import setup_training
from repro_torch.models import lstm as LS
from repro_torch.obs import print_csv_rows

HELDOUT_OFFSET = 1_000_000      # batch_at() index space disjoint from train


def restore_consensus(cfg, *, ckpt_dir: str, strategy_name: str = None,
                      n_learners: int = None, optimizer_name: str = "sgd",
                      step: int = None, device=None):
    """Rebuild the exact train-state tree (strategy x learners x
    optimizer must match the training run), restore the checkpoint into
    it, and collapse the learner replicas to the consensus params.
    Returns (params, step, meta)."""
    state, _, meta = setup_training(
        cfg, strategy_name=strategy_name, n_learners=n_learners,
        optimizer_name=optimizer_name, device=device)
    state, step = restore(ckpt_dir, state, step=step)
    params = state["params"]
    if meta["strategy"].replicated:
        params = ST.average_learners(params)
    return params, step, meta


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_params(cfg, params, *, batches: int = 4, batch: int = 8,
                    seq_len: int = None, var_len: bool = False,
                    bucket: bool = False, seed: int = 0, beam: int = None,
                    semiring: str = None, len_norm: float = None,
                    blank: int = 0, decode_chunk: int = 0,
                    topc: int = None, device=None):
    """Decode a held-out synthetic set and return the metrics dict (the
    reference's, plus ``forward_s`` and ``decode_s``, the timed batches'
    forward and decode seconds).

    ``decode_chunk`` > 0 streams each batch through the chunked decode
    (carry = beam state) in windows of that many frames — identical to
    the one-shot decode, so evaluate and the serving loop share one code
    path.  ``device`` (default: the CUDA card) is where ``params`` lie."""
    dev = resolve_device(device)
    beam = beam or getattr(cfg, "beam_width", 8)
    semiring = semiring or getattr(cfg, "beam_semiring", "max")
    len_norm = (getattr(cfg, "beam_len_norm", 0.0)
                if len_norm is None else len_norm)
    topc = getattr(cfg, "beam_topc", 0) if topc is None else topc
    seq_len = seq_len or 21

    ds = make_dataset(cfg, seq_len=seq_len, batch=batch, seed=seed,
                      var_len=var_len or bucket, bucket=bucket)

    def decode_batch(logits, lengths):
        """The chunked decode of one batch (lengths always supplied:
        full-T lengths reproduce the rectangular decode exactly)."""
        B, T, _ = logits.shape
        chunk = decode_chunk if decode_chunk > 0 else T
        st = DC.init_state(B, beam, T, dev)
        for t in range(0, T, chunk):
            st = DC.decode_chunk(st, logits[:, t:t + chunk], lengths,
                                 blank=blank, semiring=semiring, topc=topc)
        toks, lens, _ = DC.finalize(st, len_norm=len_norm,
                                    semiring=semiring)
        return toks, lens, DC.beam_occupancy(st)

    @torch.no_grad()
    def run_batch(b):
        lengths = b.get("lengths")
        feats = torch.as_tensor(b["features"])
        lens_t = (torch.full((feats.shape[0],), feats.shape[1],
                             dtype=torch.int32) if lengths is None
                  else torch.as_tensor(lengths)).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits = LS.forward(cfg, params, feats,
                            None if lengths is None else lens_t, device=dev)
        _sync(dev)
        dt_fwd = time.perf_counter() - t0
        t1 = time.perf_counter()
        toks, lens, occ = decode_batch(logits, lens_t)
        _sync(dev)
        dt_dec = time.perf_counter() - t1
        obs.add_span("eval/fwd", t0, dt_fwd, wall=True)
        obs.add_span("eval/decode", t1, dt_dec, wall=True)
        obs.histogram("eval/fwd_s", wall=True).observe(dt_fwd)
        obs.histogram("eval/decode_s", wall=True).observe(dt_dec)
        return logits, lengths, toks, lens, occ, dt_fwd, dt_dec

    # warm-up on every distinct padded shape (bucketed batches pad to
    # their own rounded max T), so the throughput rows measure forward +
    # decode, not first-call set-up (kernel builds, allocator growth)
    batch_list = [ds.batch_at(HELDOUT_OFFSET + i) for i in range(batches)]
    for shape in {b["features"].shape for b in batch_list}:
        run_batch(next(b for b in batch_list
                       if b["features"].shape == shape))

    fer_n = fer_d = 0.0
    refs, hyps_g, hyps_b = [], [], []
    valid_frames = 0
    occupancy = []
    t_fwd = t_dec = 0.0
    for b in batch_list:
        logits, lengths, toks, lens, occ, dt_fwd, dt_dec = run_batch(b)
        t_fwd += dt_fwd
        t_dec += dt_dec
        logits_np = logits.float().cpu().numpy()
        B, T, _ = logits_np.shape
        n_valid = int(lengths.sum()) if lengths is not None else B * T
        valid_frames += n_valid

        fer = frame_error_rate(logits_np, b["labels"], lengths)
        fer_n += fer * n_valid
        fer_d += n_valid
        refs += collapse_labels(b["labels"], lengths, blank=blank)
        hyps_g += greedy_ctc_decode(logits_np, lengths, blank=blank)

        occupancy.append(float(occ.float().mean()))
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        hyps_b += [list(map(int, r[:n])) for r, n in zip(toks, lens)]

    decoded = sum(len(h) for h in hyps_b)
    return {
        "fer": fer_n / max(fer_d, 1),
        "ter_greedy": token_error_rate(refs, hyps_g),
        "ter_beam": token_error_rate(refs, hyps_b),
        "beam": beam,
        "semiring": semiring,
        "valid_frames": valid_frames,
        "frames_per_s": valid_frames / max(t_fwd + t_dec, 1e-9),
        "decoded_tok_per_s": decoded / max(t_dec, 1e-9),
        "beam_occupancy": float(np.mean(occupancy)) if occupancy else 0.0,
        "forward_s": t_fwd,
        "decode_s": t_dec,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory written by repro_torch."
                         "launch.train (state restores only when "
                         "--strategy/--learners/--optimizer match the "
                         "training run)")
    ap.add_argument("--step", type=int, default=0,
                    help="checkpoint step to restore (0 = latest)")
    ap.add_argument("--strategy", default=None,
                    choices=[None] + sorted(ST.STRATEGIES))
    ap.add_argument("--learners", type=int, default=None)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch (CPU-friendly)")
    ap.add_argument("--batches", type=int, default=4,
                    help="held-out batches to decode")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=21)
    ap.add_argument("--var-len", action="store_true",
                    help="held-out set carries per-utterance lengths "
                         "(masked FER + length-aware decode)")
    ap.add_argument("--bucket", action="store_true",
                    help="length-bucketed held-out batches (implies "
                         "--var-len)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); "
                         "'cpu' runs the plain PyTorch path")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="CTC prefix-beam width (0 = cfg beam_width)")
    ap.add_argument("--beam-semiring", default="",
                    choices=["", "max", "sum"],
                    help="prefix-score merge: 'max' (Viterbi; beam=1 == "
                         "greedy) or 'sum' (log-semiring) ('' = cfg)")
    ap.add_argument("--beam-len-norm", type=float, default=-1.0,
                    help="length-normalization alpha for final ranking "
                         "(-1 = cfg beam_len_norm)")
    ap.add_argument("--beam-topc", type=int, default=-1,
                    help="per-frame top-C vocab pruning of the beam "
                         "candidate grid (0 = off, -1 = cfg beam_topc); "
                         "exact when C covers the frame support")
    ap.add_argument("--decode-chunk", type=int, default=0,
                    help="stream the decode in chunks of this many "
                         "frames, carry = beam state (0 = one shot)")
    ap.add_argument("--blank", type=int, default=0,
                    help="blank/silence class id of the TER convention")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default="",
                    help="enable observability and write the run's "
                         "flight-recorder JSONL here (eval/fwd and "
                         "eval/decode wall spans and histograms)")
    ap.add_argument("--trace-deterministic", action="store_true",
                    help="strip wall-clock fields from the JSONL so "
                         "two seeded runs emit byte-identical traces")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace_out:
        obs.configure()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family != "lstm":
        raise SystemExit("evaluate covers the acoustic (lstm) family; "
                         f"--arch {args.arch} is {cfg.family!r}")
    changes = {}
    if args.beam_width:
        changes["beam_width"] = args.beam_width
    if args.beam_semiring:
        changes["beam_semiring"] = args.beam_semiring
    if args.beam_len_norm >= 0:
        changes["beam_len_norm"] = args.beam_len_norm
    if args.beam_topc >= 0:
        changes["beam_topc"] = args.beam_topc
    if changes:
        cfg = dataclasses.replace(cfg, **changes)

    strategy = ST.get_strategy(args.strategy or cfg.train_strategy)
    params, step, meta = restore_consensus(
        cfg, ckpt_dir=args.ckpt_dir, strategy_name=strategy.name,
        n_learners=args.learners, optimizer_name=args.optimizer,
        step=args.step or None, device=device)
    print(f"restored {strategy.name} checkpoint at step {step} "
          f"(L={meta['n_learners']}, consensus params)")

    m = evaluate_params(
        cfg, params, batches=args.batches, batch=args.batch,
        seq_len=args.seq_len, var_len=args.var_len, bucket=args.bucket,
        seed=args.seed, blank=args.blank, decode_chunk=args.decode_chunk,
        device=device)

    tag = f"evaluate/{strategy.name}"
    rows = [
        (f"{tag}/fer", m["fer"], f"masked frame error rate, step {step}"),
        (f"{tag}/ter_greedy", m["ter_greedy"],
         "token error rate, best-path decode"),
        (f"{tag}/ter_beam{m['beam']}", m["ter_beam"],
         f"prefix beam, {m['semiring']} semiring"),
        (f"{tag}/frames_per_s", m["frames_per_s"],
         f"{m['valid_frames']} valid frames, forward+decode"),
        (f"{tag}/decoded_tok_per_s", m["decoded_tok_per_s"],
         "serve.py throughput convention"),
        (f"{tag}/beam_occupancy", m["beam_occupancy"],
         "live beam slots / beam width"),
    ]
    # the shared name,value,derived schema (repro_torch.obs)
    print_csv_rows(rows, header=True)
    if args.trace_out:
        n = obs.dump(args.trace_out,
                     deterministic=args.trace_deterministic)
        print(f"trace: {n} events -> {args.trace_out}")
        obs.reset()
    return m


if __name__ == "__main__":
    main()
