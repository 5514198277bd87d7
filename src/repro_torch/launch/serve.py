"""Streaming-ASR serving of the paper's acoustic model — the port of the
ASR half of ``repro/launch/serve.py``.

Requests are variable-length utterances.  Admission runs the BLSTM
forward once over the utterance (masked to its valid frames) and parks
its CD-state posteriors on the device; every decode wave then advances
all active slots by ``chunk`` frames through ONE batched
:class:`repro_torch.decode.BeamState`, the streaming carry of the CTC
prefix beam search.  On the card the forward runs the fused BLSTM kernel
and each frame the beam-step kernel; with ``device="cpu"`` both run
their plain PyTorch versions.

The server keeps the reference's slot-pool duck contract (``admit``,
``submit``, ``step``, ``step_wave``, ``preempt``, ``restore``, ``reset``,
``events``): admission returns a typed :class:`AdmitResult`, and a
preempted-then-restored request decodes bit for bit like an
uninterrupted one.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch swb2000-blstm \
        --requests 8 --slots 4 --prompt-len 256 --max-len 256
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import make_dataset
from repro_torch.decode import beam as DC
from repro_torch.device import resolve_device
from repro_torch.models import lstm as LS
from repro_torch.params import init_params
from repro_torch.serving.admission import (NO_BUDGET, OK, POOL_FULL,
                                           PROMPT_TOO_LONG, AdmitResult,
                                           prompt_capacity)


class AsrServer:
    """Streaming-ASR slot pool (``repro.launch.serve.AsrServer``).

    The parked posteriors are one (slots, max_frames, V) f32 tensor on
    the device; ``preempt`` snapshots a slot's row and beam state to the
    host.  Weights are drawn from ``seed`` (:func:`init_params`); assign
    ``server.params`` to serve other weights (e.g. carried over from JAX
    with :func:`repro_torch.params.from_jax_params`)."""

    emits_on_admit = False        # the first progress comes on a wave

    def __init__(self, cfg, *, slots: int, max_frames: int, chunk: int,
                 beam: int = 0, seed: int = 0, topc: int = None,
                 device=None, verbose: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_frames = max_frames
        self.chunk = chunk
        self.beam = beam or cfg.beam_width
        self.semiring = cfg.beam_semiring
        self.len_norm = cfg.beam_len_norm
        self.topc = cfg.beam_topc if topc is None else topc
        self.verbose = verbose
        self.params = init_params(LS.param_specs(cfg), seed, self.device)
        self.logits = torch.zeros((slots, max_frames, cfg.vocab),
                                  dtype=torch.float32, device=self.device)
        self.lens = np.zeros(slots, np.int32)     # valid frames per slot
        self.pos = np.zeros(slots, np.int32)      # frames consumed
        self.active = np.zeros(slots, bool)
        self.req_ids = [-1] * slots
        self.events = []
        self.state = DC.init_state(slots, self.beam, max_frames, self.device)

    # ------------------------------------------------------------ slots
    def _event(self, kind: str, rid: int, **kw):
        self.events.append((kind, rid, kw))
        if self.verbose:
            extra = "".join(f" {k}={v}" for k, v in kw.items())
            print(f"[req] {kind} rid={rid}{extra}", flush=True)

    def _free_slot(self) -> int:
        free = np.where(~self.active)[0]
        return int(free[0]) if len(free) else -1

    def _slot_of(self, rid: int) -> int:
        for slot in np.where(self.active)[0]:
            if self.req_ids[slot] == rid:
                return int(slot)
        raise KeyError(f"request {rid} is not active in the pool")

    def _slot_mask(self, slot: int) -> torch.Tensor:
        mask = torch.zeros(self.slots, dtype=torch.bool, device=self.device)
        mask[slot] = True
        return mask

    # -------------------------------------------------------- admission
    def admit(self, req_id: int, feats) -> AdmitResult:
        """Typed admission: ``pool_full`` (retryable), ``prompt_too_long``
        (more frames than the slot's posterior buffer) or ``no_budget``
        (an empty utterance has nothing to decode)."""
        feats = np.asarray(feats, np.float32)
        n = len(feats)
        if n > prompt_capacity(self.max_frames, "asr"):
            self._event("reject", req_id, reason=PROMPT_TOO_LONG, frames=n)
            return AdmitResult(PROMPT_TOO_LONG)
        if n == 0:
            self._event("reject", req_id, reason=NO_BUDGET)
            return AdmitResult(NO_BUDGET)
        slot = self._free_slot()
        if slot < 0:
            return AdmitResult(POOL_FULL)
        padded = np.zeros((1, self.max_frames, feats.shape[-1]), np.float32)
        padded[0, :n] = feats
        logits = LS.forward(self.cfg, self.params, torch.from_numpy(padded),
                            torch.tensor([n], dtype=torch.int32),
                            device=self.device)
        self.logits[slot] = logits[0]
        self.lens[slot] = n
        self.pos[slot] = 0
        self.active[slot] = True
        self.req_ids[slot] = req_id
        self.state = DC.reset_rows(self.state, self._slot_mask(slot))
        self._event("admit", req_id, slot=slot, frames=n)
        return AdmitResult(OK, slot)

    def submit(self, req, payload) -> AdmitResult:
        return self.admit(req.rid, payload)

    def step_wave(self):
        """One decode wave: ``(completed, progressed_rids, work)`` with
        work = valid frames consumed across the pool this wave."""
        active = np.where(self.active)[0]
        progressed = [self.req_ids[s] for s in active]
        work = int(np.minimum(
            self.chunk,
            np.maximum(self.lens[active] - self.pos[active], 0)).sum())
        done, _ = self.step()
        return done, progressed, work

    def preempt(self, rid: int):
        """Evict ``rid``: snapshot its beam row and parked posteriors to the
        host, freeze the vacated row (lens = 0), free the slot."""
        slot = self._slot_of(rid)
        snap = {
            "rid": rid,
            "logits": self.logits[slot].cpu(),
            "len": int(self.lens[slot]),
            "pos": int(self.pos[slot]),
            "beam": DC.BeamState(*(a.cpu() for a in
                                   DC.gather_rows(self.state, [slot]))),
        }
        self.active[slot] = False
        self.req_ids[slot] = -1
        self.lens[slot] = 0        # freezes the stale beam row
        self.pos[slot] = 0
        self._event("preempt", rid, slot=slot, pos=snap["pos"])
        return snap

    def restore(self, snap) -> AdmitResult:
        """Resume in any free slot; the continued decode is bit-identical
        to the uninterrupted stream."""
        slot = self._free_slot()
        if slot < 0:
            return AdmitResult(POOL_FULL)
        self.logits[slot] = snap["logits"].to(self.device)
        self.lens[slot] = snap["len"]
        self.pos[slot] = snap["pos"]
        self.state = DC.scatter_rows(self.state, snap["beam"], [slot])
        self.active[slot] = True
        self.req_ids[slot] = snap["rid"]
        self._event("restore", snap["rid"], slot=slot, pos=snap["pos"])
        return AdmitResult(OK, slot)

    def reset(self):
        self.logits.zero_()
        self.lens[:] = 0
        self.pos[:] = 0
        self.active[:] = False
        self.req_ids = [-1] * self.slots
        self.state = DC.init_state(self.slots, self.beam, self.max_frames,
                                   self.device)
        self.events.clear()

    # ------------------------------------------------------------ decode
    def step(self):
        """Advance every active slot by one chunk of frames.  Returns
        ``([(req_id, tokens), ...] for slots that finished, the live-beam
        occupancy of this wave)``."""
        C = self.chunk
        idx = np.minimum(self.pos[:, None] + np.arange(C)[None, :],
                         self.max_frames - 1)
        rows = torch.arange(self.slots, device=self.device)[:, None]
        wave = self.logits[rows, torch.from_numpy(idx).to(self.device)]
        # per-row freeze: state.t >= lens stops exhausted/empty rows
        self.state = DC.decode_chunk(
            self.state, wave, torch.from_numpy(self.lens).to(self.device),
            semiring=self.semiring, topc=self.topc)
        occ = (float(DC.beam_occupancy(self.state).cpu().numpy()
                     [self.active].mean())
               if self.active.any() else 0.0)
        self.pos = np.where(self.active,
                            np.minimum(self.pos + C, self.lens), self.pos)
        done = []
        finished = np.where(self.active & (self.pos >= self.lens))[0]
        if len(finished):
            toks, lens, _ = DC.finalize(self.state, len_norm=self.len_norm,
                                        semiring=self.semiring)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            for slot in finished:
                hyp = list(map(int, toks[slot][:int(lens[slot])]))
                rid = self.req_ids[slot]
                done.append((rid, hyp))
                self.active[slot] = False
                self._event("done", rid, slot=int(slot), tokens=len(hyp))
        return done, occ


def serve_all(server: AsrServer, pending):
    """Admit ``pending`` [(rid, feats), ...] as slots free up and decode
    until every request finishes.  Returns ``finished`` [(rid, tokens)]
    and the wall seconds of each wave (admissions included, ending in a
    host read of the wave's results)."""
    pending = list(pending)
    finished, wave_s = [], []
    while pending or server.active.any():
        t0 = time.perf_counter()
        while pending:
            res = server.admit(*pending[0])
            if res.reason == POOL_FULL:
                break
            pending.pop(0)     # admitted, or rejected for good
        done, _ = server.step()
        wave_s.append(time.perf_counter() - t0)
        finished += done
    return finished, wave_s


def asr_requests(cfg, *, requests: int, seq_len: int, seed: int = 0):
    """``requests`` variable-length synthetic utterances (rid, feats)."""
    ds = make_dataset(cfg, seq_len=seq_len, batch=max(requests, 1),
                      seed=seed, var_len=True)
    batch = ds.batch_at(0)
    return [(i, batch["features"][i, :batch["lengths"][i]])
            for i in range(requests)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="swb2000-blstm")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's smoke-test width "
                         "(2 layers, hidden 64, vocab 512)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="nominal utterance frames per request (clamped "
                         "to --max-len)")
    ap.add_argument("--max-len", type=int, default=64,
                    help="max utterance frames per slot")
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="frames decoded per wave (the streaming chunk of "
                         "the beam-state carry)")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="CTC prefix-beam width (0 = cfg beam_width)")
    ap.add_argument("--beam-topc", type=int, default=-1,
                    help="per-frame top-C vocab pruning of the beam "
                         "candidate grid (0 = off, -1 = cfg beam_topc)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    seq_len = min(args.prompt_len, prompt_capacity(args.max_len, "asr"))
    pending = asr_requests(cfg, requests=args.requests, seq_len=seq_len)
    server = AsrServer(cfg, slots=args.slots, max_frames=args.max_len,
                       chunk=args.chunk_frames, beam=args.beam_width,
                       topc=None if args.beam_topc < 0 else args.beam_topc,
                       device=args.device, verbose=True)
    frames = sum(len(f) for _, f in pending)
    t0 = time.perf_counter()
    finished, wave_s = serve_all(server, pending)
    dt = time.perf_counter() - t0
    toks = sum(len(o) for _, o in finished)
    print(f"served {len(finished)} requests on {server.device}, {toks} "
          f"tokens, {len(wave_s)} decode waves in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {frames / dt:.1f} frames/s, mean wave "
          f"{1e3 * float(np.mean(wave_s)):.2f} ms, beam {server.beam})")
    for rid, out in finished:
        print(f"  req {rid}: {out[:8]}{'...' if len(out) > 8 else ''}")


if __name__ == "__main__":
    main()
