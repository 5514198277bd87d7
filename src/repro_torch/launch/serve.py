"""Batched serving launcher of the port: continuous-batching decode loops
— the port of ``repro/launch/serve.py``.

Two request families share the slot-pool pattern (admit into free slots,
advance all active slots together, free and refill on completion):

* **LM** (the dense decoder family, e.g. ``smollm-360m`` or
  ``command-r-35b``, the vlm family, ``internvl2-2b``, served with token
  prompts as the reference serves it, the moe family, e.g.
  ``granite-moe-3b-a800m``, whose FFNs are mixtures of experts, the
  attention-free ssm family, e.g. ``mamba2-370m``, and the hybrid
  family, e.g. ``hymba-1.5b``, whose layers run attention and SSM heads
  side by side; not the encdec family, which the reference's servers
  refuse too): admission prefills the prompt and emits the first
  token; every decode wave advances the active requests one token
  through the model's ``decode_step``, and selects tokens with the
  argmax kernel (K6 port).  Prefill attention is the flash-attention
  kernel (K11 port), any prompt length up to ``max_len - 1``; decode
  attention is the decode-attention kernel (K7 port) over the dense KV
  cache of :class:`Server`, or the paged kernel (K8 port) over the
  shared page pool of :class:`PagedServer` (attention-only families:
  dense, moe and vlm).  A moe layer's dense-router FFN is the fused dense-MoE
  kernel (K10 port), in prefill and in decode.  The SSM blocks' prefill
  runs the chunked SSD scan (K9 port) in every layer; their decode
  advances per-slot conv windows and SSM states in plain torch ops.
* **ASR** (the paper's lstm family): requests are variable-length
  utterances.  Admission runs the BLSTM forward once over the utterance
  (masked to its valid frames) and parks its CD-state posteriors on the
  device; every decode wave then advances all active slots by ``chunk``
  frames through ONE batched :class:`repro_torch.decode.BeamState`, the
  streaming carry of the CTC prefix beam search, on the fused BLSTM and
  beam-step kernels.

With ``device="cpu"`` every kernel runs its plain PyTorch version.  The
servers keep the reference's slot-pool duck contract (``admit``,
``submit``, ``step``, ``step_wave``, ``preempt``, ``restore``, ``reset``,
``events``): admission returns a typed :class:`AdmitResult`, and a
preempted-then-restored request decodes bit for bit like an
uninterrupted one.

With ``--trace-out`` (observability, ``repro_torch.obs``) every
request's transitions land in the flight recorder as ``serve/*`` events,
each wave in a ``serve/wave`` span, the servers' entry points
(``serve/prefill``, ``serve/decode``, ...) in compile/steady wall-time
wrappers and the kernels' shared memory per CTA in ``kernel/*`` gauges.
Wall times on the card are host times up to a ``torch.cuda.synchronize``:
each profiled call synchronizes, so a traced run is timed with more
synchronizations than an untraced one.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 8 --slots 4 --prompt-len 128 --max-len 256 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --requests 8 --slots 4 --prompt-len 300 --max-len 512 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --requests 16 --slots 8 \
        --prompt-len 700 --max-len 1024 --max-new 24 [--cache paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
        --requests 8 --slots 4 --prompt-len 300 --max-len 512 --max-new 24 \
        [--cache paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch swb2000-blstm \
        --requests 8 --slots 4 --prompt-len 256 --max-len 256
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.data import make_dataset
from repro_torch.decode import beam as DC
from repro_torch.decode.kernel import (argmax_tokens, beam_cand_bytes,
                                       beam_slices)
from repro_torch.decode.kernel import smem_bytes as beam_smem_bytes
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import build_model
from repro_torch.models import lstm as LS
from repro_torch.models.transformer import ATTENTION_ONLY
from repro_torch.params import init_params, param_bytes, zeros_from_specs
from repro_torch.serving.admission import (NO_BUDGET, OK, POOL_FULL,
                                           PROMPT_TOO_LONG, AdmitResult,
                                           prompt_capacity)
from repro_torch.serving.kvpool import PagePool, cdiv

H100_BYTES = 80e9     # the card the port serves on, for a CPU run


def _require_decoder_only(cfg):
    """The LM servers run decoder-only families: the encdec family has no
    server (the reference's ``Server`` and ``PagedServer`` assert it
    away); its entry points are ``Model.prefill_fn`` / ``decode_fn``."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} has no LM decode loop")
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the LM servers cover decoder-only "
                         f"families, not encdec")


def require_weights_fit(model, device: torch.device):
    """ValueError when the model's weights alone exceed the memory of the
    card that would serve them: the CUDA device's own, or on the CPU (which
    runs the card's path at small widths) one H100's.  llama4-scout-17b-a16e
    at full width holds ~214 GB of bf16; command-r-35b's 60.57 GB fit."""
    nbytes = param_bytes(model.param_specs())
    cap = (torch.cuda.get_device_properties(device).total_memory
           if device.type == "cuda" else H100_BYTES)
    if nbytes > cap:
        raise ValueError(
            f"{model.cfg.name}: {nbytes / 1e9:.1f} GB of weights do not fit "
            f"one {cap / 1e9:.0f} GB card; serve it with --reduced")


def _profile_fns(server, names):
    """Wrap the server's entry points ``server._fn_<name>`` in
    compile/steady :class:`~repro_torch.obs.ProfiledFn` wall-time wrappers
    named ``serve/<name>``, only while observability is on: the wrapper
    synchronizes the card after every call, which the uninstrumented hot
    path must not pay."""
    server._profiled = []
    if not obs.enabled():
        return
    for name in names:
        p = obs.profiled(getattr(server, f"_fn_{name}"), f"serve/{name}",
                         metrics=obs.get_metrics(),
                         recorder=obs.get_recorder())
        setattr(server, f"_fn_{name}", p)
        server._profiled.append(p)


def _attn_smem_gauge(name, cfg, *, rows: int, S: int, block_s: int,
                     paged: bool, device):
    """Record the shared memory of one CTA of a server's widest decode
    attention launch (K7, or K8 when ``paged``): the delta call of
    ``rows`` requests at the last decode position of an ``S``-row cache,
    from the kernel's own plan (``decode_attention.decode_plan``), its
    splits bounded by what the card runs at once where the server runs on
    one, else by ``MAX_SPLIT``.  Tagged with the split alignment (the
    page size, paged) and the plan's splits."""
    KV, E = cfg.n_kv_heads, cfg.head_dim
    M = cfg.n_heads // KV
    n_fit = (DA.fit_splits(True, M, E, rows * KV) if device.type == "cuda"
             else DA.MAX_SPLIT)
    plan = DA.decode_plan(rows, KV, S, E, S - 2, cfg.window or None, True,
                          block_s, n_fit)
    align = {"page_size" if paged else "block_s": block_s}
    obs.gauge(name, splits=plan.n_split, **align).set(
        DA.smem_bytes(plan, M, E, paged))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_pairs(dst, src):
    """The (dst, src) leaf pairs of two trees of one structure."""
    if isinstance(dst, dict):
        for k in dst:
            yield from _tree_pairs(dst[k], src[k])
    else:
        yield dst, src


def select_tokens(logits) -> list:
    """(B, V) logits -> B host ints: one argmax kernel launch and one host
    copy for the whole group."""
    return argmax_tokens(logits.contiguous()).cpu().tolist()


class _Events:
    """The structured per-request event stream of every server, and the
    host -> device copy of its int32 bookkeeping (tokens, slots, pages)."""

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _event(self, kind: str, rid: int, **kw):
        self.events.append((kind, rid, kw))
        obs.event(f"serve/{kind}", rid=rid, **kw)
        if self.verbose:
            extra = "".join(f" {k}={v}" for k, v in kw.items())
            print(f"[req] {kind} rid={rid}{extra}", flush=True)


class _SlotPool(_Events):
    """Shared slot-pool bookkeeping: the rid -> slot map and the event
    stream."""

    emits_on_admit = False        # the first progress comes on a wave

    def __init__(self, slots: int, verbose: bool = False):
        self.slots = slots
        self.active = np.zeros(slots, bool)
        self.req_ids = [-1] * slots
        self.events = []
        self.verbose = verbose

    def _free_slot(self) -> int:
        free = np.where(~self.active)[0]
        return int(free[0]) if len(free) else -1

    def _slot_of(self, rid: int) -> int:
        for slot in np.where(self.active)[0]:
            if self.req_ids[slot] == rid:
                return int(slot)
        raise KeyError(f"request {rid} is not active in the pool")

    def active_requests(self):
        return [self.req_ids[s] for s in np.where(self.active)[0]]


class Server(_SlotPool):
    """LM continuous batching over a stacked decode-state cache
    (``repro.launch.serve.Server``).

    The cache is a tree whose leaves carry (L, slots, ...) on the device:
    {'attn': {'k', 'v'}}, each (L, slots, max_len, KV, E) bf16, for the
    dense, moe and vlm families; {'ssm': {'conv': {'x', 'B', 'C'}, 'h'}}
    for the ssm family; both for the hybrid family.  Admission, preemption
    and restore move a slot's row of every leaf.  Weights are drawn from
    ``seed`` on the server's device (:func:`init_params`).
    Assign ``server.params`` to serve other weights (e.g. carried over
    from JAX with :func:`repro_torch.params.from_jax_params`)."""

    emits_on_admit = True      # prefill emits the first token at admission

    def __init__(self, cfg, *, slots: int, max_len: int, seed: int = 0,
                 batched: bool = True, device=None, verbose: bool = False):
        _require_decoder_only(cfg)
        super().__init__(slots, verbose)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.device = resolve_device(device)
        self.max_len = max_len
        self.batched = batched
        self.params = init_params(self.model.param_specs(), seed,
                                  self.device)
        self.cache = zeros_from_specs(self.model.cache_specs(slots, max_len),
                                      self.device)
        self.pos = np.zeros(slots, np.int32)          # next write position
        self.tokens = np.zeros((slots, 1), np.int32)  # last emitted token
        self.budget = np.zeros(slots, np.int32)
        self.outputs = [[] for _ in range(slots)]
        _profile_fns(self, ("prefill", "decode"))
        if obs.enabled() and cfg.family in ATTENTION_ONLY:
            _attn_smem_gauge("kernel/decode_attn_smem_bytes", cfg,
                             rows=slots, S=max_len,
                             block_s=DA.DEFAULT_BLOCK_S, paged=False,
                             device=self.device)

    # ---------------------------------------------- profiled entry points
    def _fn_prefill(self, tokens):
        return self.model.prefill_fn(self.params, {"tokens": tokens},
                                     cache_len=self.max_len)

    def _fn_decode(self, rows, toks, pos):
        return self.model.decode_fn(self.params, rows, toks, pos)

    # ------------------------------------------------------------------
    def admit(self, req_id: int, prompt, max_new: int) -> AdmitResult:
        """Claim a free slot, prefill, emit the first token.  Typed
        rejection: ``pool_full`` (retryable), ``prompt_too_long`` (one of
        the slot's max_len positions is reserved for the first generated
        token) or ``no_budget`` (max_new <= 0)."""
        prompt = np.asarray(prompt)
        if len(prompt) > prompt_capacity(self.max_len, "lm"):
            self._event("reject", req_id, reason=PROMPT_TOO_LONG,
                        prompt=len(prompt))
            return AdmitResult(PROMPT_TOO_LONG)
        if max_new <= 0:
            self._event("reject", req_id, reason=NO_BUDGET)
            return AdmitResult(NO_BUDGET)
        slot = self._free_slot()
        if slot < 0:
            return AdmitResult(POOL_FULL)
        logits, row = self._fn_prefill(self._on_device(prompt[None, :]))
        for dst, src in _tree_pairs(self.cache, row):
            dst[:, slot] = src[:, 0]
        nxt = select_tokens(logits[:, -1])[0]
        self.pos[slot] = len(prompt)
        self.tokens[slot, 0] = nxt
        self.active[slot] = True
        self.budget[slot] = max_new - 1
        self.outputs[slot] = [nxt]
        self.req_ids[slot] = req_id
        self._event("admit", req_id, slot=slot, prompt=len(prompt))
        return AdmitResult(OK, slot)

    # ----------------------------------------------------- duck contract
    def submit(self, req, payload) -> AdmitResult:
        return self.admit(req.rid, payload, req.max_new)

    def step_wave(self):
        """One decode wave: ``(completed, progressed_rids, work)`` —
        every active slot advances one token, so work = active count."""
        progressed = self.active_requests()
        done = self.step()
        return done, progressed, len(progressed)

    def preempt(self, rid: int):
        """Evict ``rid``: snapshot its cache row to the host plus the
        position/budget/output bookkeeping, free the slot."""
        slot = self._slot_of(rid)
        snap = {
            "rid": rid,
            "pos": int(self.pos[slot]),
            "token": int(self.tokens[slot, 0]),
            "budget": int(self.budget[slot]),
            "outputs": list(self.outputs[slot]),
            "row": _tree_map(lambda c: c[:, slot:slot + 1].cpu(),
                             self.cache),
        }
        self.active[slot] = False
        self.req_ids[slot] = -1
        self._event("preempt", rid, slot=slot, pos=snap["pos"])
        return snap

    def restore(self, snap) -> AdmitResult:
        """Resume a preempted request in any free slot; the cache row
        round-trips exactly, so the continued decode is bit-identical to
        the uninterrupted one."""
        slot = self._free_slot()
        if slot < 0:
            return AdmitResult(POOL_FULL)
        for dst, src in _tree_pairs(self.cache, snap["row"]):
            dst[:, slot:slot + 1] = src.to(self.device)
        self.pos[slot] = snap["pos"]
        self.tokens[slot, 0] = snap["token"]
        self.budget[slot] = snap["budget"]
        self.outputs[slot] = list(snap["outputs"])
        self.active[slot] = True
        self.req_ids[slot] = snap["rid"]
        self._event("restore", snap["rid"], slot=slot, pos=snap["pos"])
        return AdmitResult(OK, slot)

    def reset(self):
        """Clear every slot (weights and cache buffers are kept)."""
        _tree_map(torch.Tensor.zero_, self.cache)
        self.pos[:] = 0
        self.active[:] = False
        self.tokens[:] = 0
        self.budget[:] = 0
        self.outputs = [[] for _ in range(self.slots)]
        self.req_ids = [-1] * self.slots
        self.events.clear()

    # ------------------------------------------------------------------
    def _decode(self, group, pos: int) -> list:
        """Decode the slots of ``group`` (all at ``pos``) as ONE batched
        call; returns their next tokens.  Contiguous slots decode on views
        of the cache, so the step writes in place; other groups gather
        their rows and scatter back what the step wrote: the new KV column,
        the whole ssm rows, or both (the hybrid family)."""
        toks = self._on_device(self.tokens[group])
        lo = group[0]
        if list(group) == list(range(lo, lo + len(group))):
            rows = _tree_map(lambda c: c[:, lo:lo + len(group)], self.cache)
            logits, _ = self._fn_decode(rows, toks, pos)
        else:
            idx = self._on_device(group).long()
            rows = _tree_map(lambda c: c[:, idx], self.cache)
            logits, rows = self._fn_decode(rows, toks, pos)
            if "attn" in rows:
                for name in ("k", "v"):
                    self.cache["attn"][name][:, idx, pos] = \
                        rows["attn"][name][:, :, pos]
            if "ssm" in rows:
                for dst, src in _tree_pairs(self.cache["ssm"], rows["ssm"]):
                    dst[:, idx] = src
        return select_tokens(logits[:, -1])

    def step(self):
        """Advance every active slot by one token.

        Slots are grouped by cache position and each group decodes as ONE
        batched call — bit-identical to the per-slot decode
        (``batched=False``, the reference loop) wherever the batched
        products round as the per-row ones do (the CPU tests hold it)."""
        if not self.batched:
            return self._step_sequential()
        done = []
        active = np.where(self.active)[0]
        for p in sorted({int(self.pos[s]) for s in active}):
            group = [int(s) for s in active if self.pos[s] == p]
            for slot, nxt in zip(group, self._decode(group, p)):
                self._advance_slot(slot, nxt, done)
        return done

    def _step_sequential(self):
        done = []
        for slot in np.where(self.active)[0]:
            slot = int(slot)
            nxt = self._decode([slot], int(self.pos[slot]))[0]
            self._advance_slot(slot, nxt, done)
        return done

    def _advance_slot(self, slot: int, nxt: int, done):
        self.outputs[slot].append(nxt)
        self.tokens[slot, 0] = nxt
        self.pos[slot] += 1
        self.budget[slot] -= 1
        if self.budget[slot] <= 0 or self.pos[slot] >= self.max_len - 1:
            self.active[slot] = False
            rid = self.req_ids[slot]
            done.append((rid, list(self.outputs[slot])))
            self._event("done", rid, slot=slot,
                        tokens=len(self.outputs[slot]))


class PagedServer(_Events):
    """LM continuous batching over a PAGED KV cache (``--cache paged``;
    ``repro.launch.serve.PagedServer``).

    Same duck contract and decode loop as :class:`Server`, but the
    physical cache is one shared pool of ``pool_pages`` pages of
    ``page_size`` positions, and capacity is the page budget, not a slot
    count.  Host-side bookkeeping (refcounts, the prompt-prefix trie,
    COW) lives in :class:`repro_torch.serving.kvpool.PagePool`; this
    class owns the device page arrays and applies the pool's decisions:

    * **admit** — pages are reserved eagerly (all-or-nothing).  Worst-case
      demand beyond the whole pool is the terminal ``no_budget``; too few
      free pages right now is the retryable ``pool_full``.  Prefill runs
      over the prompt with its cache padded to whole pages, and only the
      OWNED pages are written: trie-shared prefix pages already hold the
      bytes.
    * **step** — equal-position groups decode as one batched call through
      the paged kernel, the requests' page tables stacked into a (Bg, W)
      table; W is the widest request's page count rounded up to a power
      of two.  Before the wave's cache write, ``pool.ensure_writable``
      COWs any shared page (a device page copy here).
    * **preempt/restore** — the snapshot is the table's pages on the host;
      restore re-allocates through the trie and writes the owned pages.

    Attention-only (the dense, moe and vlm families): a family with
    per-slot SSM state (ssm, hybrid), or with an encoder (encdec), raises
    ValueError.
    """

    emits_on_admit = True

    def __init__(self, cfg, *, pool_pages: int, page_size: int,
                 max_len: int, seed: int = 0, share: bool = True,
                 device=None, verbose: bool = False):
        _require_decoder_only(cfg)
        if cfg.family not in ATTENTION_ONLY:
            raise ValueError(f"paged KV cache needs an attention-only "
                             f"family, got {cfg.family}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.device = resolve_device(device)
        self.max_len = max_len
        self.page_size = page_size
        self.table_w = cdiv(max_len, page_size)
        self.pool = PagePool(pool_pages, page_size, seed=seed, share=share)
        self.events = []
        self.verbose = verbose
        self.peak_sharing = 0.0
        self.params = init_params(self.model.param_specs(), seed,
                                  self.device)
        pages = zeros_from_specs(self.model.page_specs(pool_pages, page_size),
                                 self.device)
        self.k_pages = pages["attn"]["k"]
        self.v_pages = pages["attn"]["v"]
        self.reqs = {}    # rid -> {pos, token, budget, outputs, ...}
        _profile_fns(self, ("prefill", "decode", "write", "copy_page"))
        if obs.enabled():
            _attn_smem_gauge("kernel/paged_attn_smem_bytes", cfg,
                             rows=max(1, pool_pages // self.table_w),
                             S=self.table_w * page_size, block_s=page_size,
                             paged=True, device=self.device)

    # ---------------------------------------------- profiled entry points
    def _fn_prefill(self, tokens, cache_len: int):
        return self.model.prefill_fn(self.params, {"tokens": tokens},
                                     cache_len=cache_len)

    def _fn_decode(self, toks, pos: int, table):
        return self.model.decode_fn(
            self.params, {"attn": {"k": self.k_pages, "v": self.v_pages}},
            toks, pos, page_table=table, page_size=self.page_size)

    @staticmethod
    def _fn_write(pool, rows, idx):
        """Write ``rows`` (L, n, P, KV, E) into the pool's pages ``idx``."""
        pool[:, idx] = rows
        return pool

    @staticmethod
    def _fn_copy_page(pool, src: int, dst: int):
        pool[:, dst] = pool[:, src]
        return pool

    @property
    def active(self):
        """In-flight mask (one entry per live request, not per slot)."""
        return np.ones(len(self.reqs), bool)

    def active_requests(self):
        return list(self.reqs)

    def occupancy(self) -> float:
        return self.pool.pages_in_use / self.pool.n_pages

    # ------------------------------------------------------------------
    def admit(self, req_id: int, prompt, max_new: int) -> AdmitResult:
        """Page-budget admission.  Typed rejection: ``prompt_too_long``,
        ``no_budget`` (max_new <= 0, or worst-case page demand beyond the
        whole pool: terminal), ``pool_full`` (too few free pages now:
        retryable)."""
        prompt = np.asarray(prompt)
        plen = len(prompt)
        if plen > prompt_capacity(self.max_len, "lm"):
            self._event("reject", req_id, reason=PROMPT_TOO_LONG,
                        prompt=plen)
            return AdmitResult(PROMPT_TOO_LONG)
        total = min(plen + max_new, self.max_len)
        if max_new <= 0 or self.pool.pages_for(total) > self.pool.n_pages:
            self._event("reject", req_id, reason=NO_BUDGET,
                        pages=self.pool.pages_for(max(total, 0)),
                        pool=self.pool.n_pages)
            return AdmitResult(NO_BUDGET)
        alloc = self.pool.alloc_request(req_id, prompt, total)
        if alloc is None:
            return AdmitResult(POOL_FULL)
        P = self.page_size
        logits, row = self._fn_prefill(self._on_device(prompt[None, :]),
                                       cdiv(plen, P) * P)
        self._write_owned(row, alloc.table, alloc.owned,
                          n_pages=cdiv(plen, P))
        nxt = select_tokens(logits[:, -1])[0]
        self.reqs[req_id] = {
            "pos": plen, "token": nxt, "budget": max_new - 1,
            "outputs": [nxt], "prompt": tuple(int(t) for t in prompt),
            "total": total,
        }
        self.peak_sharing = max(self.peak_sharing, self.pool.sharing_ratio)
        self._event("admit", req_id, prompt=plen,
                    pages=alloc.n_pages, shared=alloc.n_shared,
                    in_use=self.pool.pages_in_use)
        return AdmitResult(OK, 0)

    def _write_owned(self, row, table, owned, n_pages):
        """Scatter an (L, 1, n_pages * P, KV, E) prefill row into the
        OWNED physical pages of the first ``n_pages`` table entries."""
        own = [j for j in range(n_pages) if owned[j]]
        if not own:
            return
        phys = self._on_device([table[j] for j in own]).long()
        P = self.page_size
        for name, pool in (("k", self.k_pages), ("v", self.v_pages)):
            arr = row["attn"][name]
            L, _, pp, KV, E = arr.shape
            self._fn_write(pool, arr[:, 0].reshape(L, pp // P, P, KV, E)
                           [:, own], phys)

    # ----------------------------------------------------- duck contract
    def submit(self, req, payload) -> AdmitResult:
        return self.admit(req.rid, payload, req.max_new)

    def step_wave(self):
        progressed = self.active_requests()
        done = self.step()
        return done, progressed, len(progressed)

    def preempt(self, rid: int):
        """Evict ``rid``: snapshot its table's pages to the host plus the
        bookkeeping, release the pages to the pool."""
        r = self.reqs.pop(rid)
        table = self.pool.table_of(rid)
        idx = self._on_device(table).long()
        snap = {
            "rid": rid, "pos": r["pos"], "token": r["token"],
            "budget": r["budget"], "outputs": list(r["outputs"]),
            "prompt": r["prompt"], "total": r["total"],
            "pages_k": self.k_pages[:, idx].cpu(),
            "pages_v": self.v_pages[:, idx].cpu(),
        }
        self.pool.free_request(rid)
        self._event("preempt", rid, pos=r["pos"], pages=len(table))
        return snap

    def restore(self, snap) -> AdmitResult:
        """Resume a preempted request: re-allocate through the trie
        (prompt pages may re-share; pages holding decode output never do)
        and write the snapshot into the owned pages."""
        rid = snap["rid"]
        alloc = self.pool.alloc_request(rid, snap["prompt"], snap["total"],
                                        written_upto=snap["pos"])
        if alloc is None:
            return AdmitResult(POOL_FULL)
        own = [j for j in range(alloc.n_pages) if alloc.owned[j]]
        if own:
            phys = self._on_device([alloc.table[j] for j in own]).long()
            self._fn_write(self.k_pages,
                           snap["pages_k"][:, own].to(self.device), phys)
            self._fn_write(self.v_pages,
                           snap["pages_v"][:, own].to(self.device), phys)
        self.reqs[rid] = {k: snap[k] for k in
                          ("pos", "token", "budget", "prompt", "total")}
        self.reqs[rid]["outputs"] = list(snap["outputs"])
        self.peak_sharing = max(self.peak_sharing, self.pool.sharing_ratio)
        self._event("restore", rid, pos=snap["pos"], shared=alloc.n_shared)
        return AdmitResult(OK, 0)

    def reset(self):
        self.pool.reset()
        self.k_pages.zero_()
        self.v_pages.zero_()
        self.reqs.clear()
        self.events.clear()
        self.peak_sharing = 0.0

    # ------------------------------------------------------------------
    def step(self):
        """Advance every in-flight request one token: equal-position
        groups share one batched decode (the dense server's grouping and
        finish rules, so outputs equal its outputs given equal logits);
        shared pages COW before the wave's cache write."""
        done = []
        P = self.page_size
        for p in sorted({r["pos"] for r in self.reqs.values()}):
            group = [rid for rid, r in self.reqs.items() if r["pos"] == p]
            for rid in group:    # COW before the device write at p
                moved = self.pool.ensure_writable(rid, p)
                if moved is not None:
                    src, dst = moved
                    self._fn_copy_page(self.k_pages, src, dst)
                    self._fn_copy_page(self.v_pages, src, dst)
                    self._event("cow", rid, pos=p, src=src, dst=dst)
            # attend only the pages the group can reach: the widest
            # request's page count, rounded up to a power of two
            w_need = max(cdiv(self.reqs[rid]["total"], P) for rid in group)
            w_use = min(self.table_w, 1 << max(w_need - 1, 0).bit_length())
            tbl = np.zeros((len(group), w_use), np.int32)
            for i, rid in enumerate(group):
                t = self.pool.table_of(rid)
                tbl[i, :len(t)] = t[:w_use]
            toks = self._on_device([[self.reqs[rid]["token"]]
                                    for rid in group])
            logits, _ = self._fn_decode(toks, p, self._on_device(tbl))
            for rid, nxt in zip(group, select_tokens(logits[:, -1])):
                self._advance(rid, nxt, done)
        return done

    def _advance(self, rid, nxt: int, done):
        r = self.reqs[rid]
        r["outputs"].append(nxt)
        r["token"] = nxt
        r["pos"] += 1
        r["budget"] -= 1
        # the dense Server's finish rule -> identical outputs
        if r["budget"] <= 0 or r["pos"] >= self.max_len - 1:
            done.append((rid, list(r["outputs"])))
            self._event("done", rid, tokens=len(r["outputs"]),
                        in_use=self.pool.pages_in_use)
            self.pool.free_request(rid)
            del self.reqs[rid]


class AsrServer(_SlotPool):
    """Streaming-ASR slot pool (``repro.launch.serve.AsrServer``).

    The parked posteriors are one (slots, max_frames, V) f32 tensor on
    the device; ``preempt`` snapshots a slot's row and beam state to the
    host.  Weights are drawn from ``seed`` (:func:`init_params`); assign
    ``server.params`` to serve other weights (e.g. carried over from JAX
    with :func:`repro_torch.params.from_jax_params`)."""

    def __init__(self, cfg, *, slots: int, max_frames: int, chunk: int,
                 beam: int = 0, seed: int = 0, topc: int = None,
                 device=None, verbose: bool = False):
        self.device = resolve_device(device)
        super().__init__(slots, verbose)
        self.cfg = cfg
        self.max_frames = max_frames
        self.chunk = chunk
        self.beam = beam or cfg.beam_width
        self.semiring = cfg.beam_semiring
        self.len_norm = cfg.beam_len_norm
        self.topc = cfg.beam_topc if topc is None else topc
        self.params = init_params(LS.param_specs(cfg), seed, self.device)
        self.logits = torch.zeros((slots, max_frames, cfg.vocab),
                                  dtype=torch.float32, device=self.device)
        self.lens = np.zeros(slots, np.int32)     # valid frames per slot
        self.pos = np.zeros(slots, np.int32)      # frames consumed
        self.state = DC.init_state(slots, self.beam, max_frames, self.device)
        _profile_fns(self, ("fwd", "decode", "finalize"))
        if obs.enabled():
            n_sm = (torch.cuda.get_device_properties(self.device)
                    .multi_processor_count
                    if self.device.type == "cuda" else 1)
            topc = 0 if self.topc >= cfg.vocab else self.topc
            slices = beam_slices(slots, cfg.vocab, n_sm)
            obs.gauge("kernel/beam_cand_bytes", beam=self.beam,
                      topc=self.topc).set(
                beam_cand_bytes(self.beam, cfg.vocab, self.topc))
            obs.gauge("kernel/beam_smem_bytes", beam=self.beam,
                      topc=self.topc, slices=slices).set(
                beam_smem_bytes(self.beam, cfg.vocab, topc, slices))

    # ---------------------------------------------- profiled entry points
    def _fn_fwd(self, feats, lengths):
        return LS.forward(self.cfg, self.params, feats, lengths,
                          device=self.device)

    def _fn_decode(self, state, wave, lens):
        return DC.decode_chunk(state, wave, lens, semiring=self.semiring,
                               topc=self.topc)

    def _fn_finalize(self, state):
        return DC.finalize(state, len_norm=self.len_norm,
                           semiring=self.semiring)

    # ------------------------------------------------------------ slots
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
        logits = self._fn_fwd(torch.from_numpy(padded),
                              torch.tensor([n], dtype=torch.int32))
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
        self.state = self._fn_decode(
            self.state, wave, torch.from_numpy(self.lens).to(self.device))
        occ = (float(DC.beam_occupancy(self.state).cpu().numpy()
                     [self.active].mean())
               if self.active.any() else 0.0)
        self.pos = np.where(self.active,
                            np.minimum(self.pos + C, self.lens), self.pos)
        done = []
        finished = np.where(self.active & (self.pos >= self.lens))[0]
        if len(finished):
            toks, lens, _ = self._fn_finalize(self.state)
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
        with obs.span("serve/wave", wave=len(wave_s)):
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


def lm_requests(cfg, lengths, *, shared_prefix: int = 0, seed: int = 0):
    """Synthetic LM prompts [(rid, tokens)], one per entry of ``lengths``:
    a common prefix of ``shared_prefix`` tokens, then random tokens (the
    reference CLI's draw order for equal lengths)."""
    rng = np.random.default_rng(seed)
    shared = min([shared_prefix, *lengths])
    prefix = rng.integers(0, cfg.vocab, size=shared)
    return [(i, np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                     size=n - shared)]))
            for i, n in enumerate(lengths)]


def serve_lm(server, pending, max_new: int):
    """Admit ``pending`` [(rid, prompt), ...] as capacity frees up and
    decode until every request finishes.  Returns ``finished`` [(rid,
    tokens)], the wall seconds of each admission (prefill + first token)
    and of each decode wave (both end in a host read of their tokens),
    and the mean occupancy per wave (slots, or pool pages when paged)."""
    pending = list(pending)
    finished, admit_s, wave_s, occ = [], [], [], 0.0
    paged = isinstance(server, PagedServer)
    while pending or server.active.any():
        while pending:
            t0 = time.perf_counter()
            res = server.admit(pending[0][0], pending[0][1], max_new)
            if res.reason == POOL_FULL:
                break
            admit_s.append(time.perf_counter() - t0)
            pending.pop(0)      # admitted, or rejected for good
        occ += server.occupancy() if paged else float(server.active.mean())
        t0 = time.perf_counter()
        with obs.span("serve/wave", wave=len(wave_s)):
            finished += server.step()
        wave_s.append(time.perf_counter() - t0)
    return finished, admit_s, wave_s, occ / max(len(wave_s), 1)


def _finish_trace(server, args):
    """End of a traced run: each profiled entry point's first-call and
    steady wall time, then the flight recorder's JSONL."""
    for p in getattr(server, "_profiled", []):
        n = p.n_calls - p.n_compiles
        print(f"timing: {p.name} compile {p.compile_s:.2f}s "
              f"({p.n_compiles} compile(s)), steady {p.steady_s:.3f}s "
              f"over {n} calls", flush=True)
    if args.trace_out:
        n = obs.dump(args.trace_out,
                     deterministic=args.trace_deterministic)
        print(f"trace: {n} events -> {args.trace_out}")
        obs.reset()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="smollm-360m, phi3-medium-14b, stablelm-12b or "
                         "command-r-35b (dense LM), internvl2-2b (vlm LM, "
                         "token prompts), granite-moe-3b-a800m or "
                         "llama4-scout-17b-a16e (moe LM; llama4 --reduced "
                         "only), mamba2-370m (ssm LM), hymba-1.5b (hybrid "
                         "LM) or swb2000-blstm (ASR); whisper-large-v3 "
                         "(encdec) has no server")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's smoke-test width (2 "
                         "layers, d_model <= 256, vocab <= 512; lstm: "
                         "hidden 64)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt tokens (LM) / nominal utterance frames "
                         "(ASR) per request (clamped to --max-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64,
                    help="cache capacity (LM) / max utterance frames "
                         "(ASR) per slot")
    ap.add_argument("--cache", default="", choices=["", "dense", "paged"],
                    help="LM KV-cache layout: dense per-slot rows or the "
                         "paged page-pool server with prompt-prefix "
                         "sharing (default: cfg.cache_mode)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="cache positions per KV page in --cache paged "
                         "(0 = cfg.page_size; must divide --max-len)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical pages in the paged pool (0 = the "
                         "dense-equivalent memory: slots * max_len / "
                         "page_size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="LM mode: length of a common prompt prefix shared "
                         "by all requests (0 = fully random prompts)")
    ap.add_argument("--sequential", action="store_true",
                    help="LM mode: decode active slots one at a time "
                         "instead of batching equal-position groups")
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="ASR mode: frames decoded per wave (the streaming "
                         "chunk of the beam-state carry)")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="ASR mode: CTC prefix-beam width (0 = cfg "
                         "beam_width)")
    ap.add_argument("--beam-topc", type=int, default=-1,
                    help="ASR mode: per-frame top-C vocab pruning of the "
                         "beam candidate grid (0 = off, -1 = cfg beam_topc)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--trace-out", default="",
                    help="enable observability and write the run's "
                         "flight-recorder JSONL here (per-request events, "
                         "serve/wave spans, compile/steady timings of the "
                         "entry points, the kernels' shared-memory gauges; "
                         "render with repro_torch.launch.obsreport)")
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
    if cfg.family == "lstm":
        return _main_asr(cfg, args, device)

    try:
        require_weights_fit(build_model(cfg), device)
    except ValueError as e:
        ap.error(str(e))
    cache_mode = args.cache or cfg.cache_mode
    if cache_mode == "paged":
        page = args.page_size or cfg.page_size
        pool_pages = args.pool_pages or args.slots * cdiv(args.max_len, page)
        try:
            server = PagedServer(cfg, pool_pages=pool_pages, page_size=page,
                                 max_len=args.max_len, device=device,
                                 verbose=True)
        except ValueError as e:
            ap.error(f"--cache paged: {e}")
    else:
        try:
            server = Server(cfg, slots=args.slots, max_len=args.max_len,
                            batched=not args.sequential, device=device,
                            verbose=True)
        except ValueError as e:
            ap.error(str(e))
    plen = min(args.prompt_len, prompt_capacity(args.max_len, "lm"))
    pending = lm_requests(cfg, [plen] * args.requests,
                          shared_prefix=args.shared_prefix)
    t0 = time.perf_counter()
    finished, _, wave_s, occ = serve_lm(server, pending, args.max_new)
    dt = time.perf_counter() - t0
    toks = sum(len(o) for _, o in finished)
    print(f"served {len(finished)} requests on {server.device}, {toks} "
          f"tokens, {len(wave_s)} decode waves in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, occupancy {occ:.2f}, mean wave "
          f"{1e3 * float(np.mean(wave_s)):.2f} ms)")
    if cache_mode == "paged":
        print(f"[kv] pool={server.pool.n_pages} pages x "
              f"{server.page_size} positions, peak "
              f"sharing_ratio={server.peak_sharing:.3f}, "
              f"cow={server.pool.n_cow}, "
              f"shared_hits={server.pool.n_shared_hits}")
    for rid, out in finished:
        print(f"  req {rid}: {out[:8]}{'...' if len(out) > 8 else ''}")
    _finish_trace(server, args)


def _main_asr(cfg, args, device):
    """Streaming-ASR serving of synthetic utterances from the data
    pipeline's length distribution, chunked beam decode."""
    seq_len = min(args.prompt_len, prompt_capacity(args.max_len, "asr"))
    pending = asr_requests(cfg, requests=args.requests, seq_len=seq_len)
    server = AsrServer(cfg, slots=args.slots, max_frames=args.max_len,
                       chunk=args.chunk_frames, beam=args.beam_width,
                       topc=None if args.beam_topc < 0 else args.beam_topc,
                       device=device, verbose=True)
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
    _finish_trace(server, args)


if __name__ == "__main__":
    main()
