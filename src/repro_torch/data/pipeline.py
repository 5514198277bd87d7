"""Synthetic training data — the port's own copy of ``SyntheticASRDataset``
(utterances for the paper's BLSTM acoustic model), ``SyntheticLMDataset``
(Markov token streams), ``SyntheticSeq2SeqDataset`` (frame embeddings to
token transcripts, the encdec family), ``SyntheticVLMDataset`` (patch
embeddings before Markov text) and ``make_dataset`` from
``repro/data/pipeline.py``.

Numpy only, with the reference's draw order, so the same seed gives the
same batches byte for byte.  Features come from per-class Gaussian
clusters with Zipf-distributed class priors (CD-state occupancy is very
uneven).  With ``var_len=True`` every batch carries ``lengths``
(lognormal utterance lengths, features and labels zeroed beyond them);
``bucket=True`` sorts utterances by length inside a shuffle window of
``bucket_window`` batches and pads each batch to its own rounded max.
:class:`Prefetcher` synthesizes batches on a host thread ahead of the
step that consumes them.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


def _rng(seed, step):
    return np.random.default_rng(np.uint64(seed * 1_000_003 + step))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass
class SyntheticASRDataset:
    """Frame-classification data: ``batch_at(step)`` returns ``features``
    (B, T, D) f32, ``labels`` (B, T) i32 and, with ``var_len``,
    ``lengths`` (B,) i32."""

    input_dim: int
    n_classes: int
    seq_len: int
    batch: int
    seed: int = 0
    n_effective_classes: int = 64   # rank of the learnable structure
    var_len: bool = False
    min_len: int = 4
    len_sigma: float = 0.6          # lognormal spread of utterance lengths
    bucket: bool = False            # sort-within-shuffle-window batching
    bucket_window: int = 16         # shuffle window, in batches
    pad_multiple: int = 8           # bucketed Tpad rounds up to this

    def __post_init__(self):
        r = np.random.default_rng(self.seed)
        k = min(self.n_effective_classes, self.n_classes)
        self.centroids = r.normal(size=(k, self.input_dim)).astype(np.float32)
        pri = 1.0 / np.arange(1, k + 1)
        self.priors = pri / pri.sum()
        self.k = k
        self._wcache = None          # (window_idx, lens, feats, cls)

    def _window(self, w: int):
        """All utterances of shuffle window ``w``, a pure function of
        (seed, w)."""
        if self._wcache is not None and self._wcache[0] == w:
            return self._wcache[1:]
        N = self.bucket_window * self.batch
        r = np.random.default_rng((np.uint64(self.seed), np.uint64(w), 2))
        med = max(self.min_len, int(0.6 * self.seq_len))
        lens = np.clip(
            np.rint(r.lognormal(np.log(med), self.len_sigma, size=N)),
            self.min_len, self.seq_len).astype(np.int32)
        cls = r.choice(self.k, size=(N, self.seq_len), p=self.priors)
        feats = (self.centroids[cls]
                 + 0.5 * r.normal(size=(N, self.seq_len,
                                        self.input_dim))).astype(np.float32)
        valid = np.arange(self.seq_len)[None, :] < lens[:, None]
        feats *= valid[..., None]
        cls = np.where(valid, cls, 0).astype(np.int32)
        self._wcache = (w, lens, feats, cls)
        return lens, feats, cls

    def batch_at(self, step: int):
        if not self.var_len:
            r = _rng(self.seed, step)
            cls = r.choice(self.k, size=(self.batch, self.seq_len),
                           p=self.priors)
            feats = (self.centroids[cls]
                     + 0.5 * r.normal(size=(self.batch, self.seq_len,
                                            self.input_dim))
                     ).astype(np.float32)
            return {"features": feats, "labels": cls.astype(np.int32)}

        w, j = divmod(step, self.bucket_window)
        lens, feats, cls = self._window(w)
        order = (np.argsort(lens, kind="stable") if self.bucket
                 else np.arange(len(lens)))
        rows = order[j * self.batch:(j + 1) * self.batch]
        blens = lens[rows]
        tpad = (min(self.seq_len,
                    _round_up(int(blens.max()), self.pad_multiple))
                if self.bucket else self.seq_len)
        return {"features": feats[rows, :tpad],
                "labels": cls[rows, :tpad],
                "lengths": blens}


@dataclass
class SyntheticLMDataset:
    """First-order Markov token streams (learnable next-token structure):
    ``tokens`` and ``labels`` (B, S) i32, labels the tokens shifted by
    one."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    effective_vocab: int = 256
    temperature: float = 0.3

    def __post_init__(self):
        r = np.random.default_rng(self.seed)
        k = min(self.effective_vocab, self.vocab)
        logits = r.normal(size=(k, k)) / self.temperature
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self.trans = (e / e.sum(-1, keepdims=True)).astype(np.float64)
        self.k = k

    def batch_at(self, step: int):
        r = _rng(self.seed, step)
        B, S = self.batch, self.seq_len
        toks = np.zeros((B, S + 1), np.int32)
        toks[:, 0] = r.integers(0, self.k, size=B)
        # inverse-CDF sampling of each next token
        cdf = np.cumsum(self.trans, axis=-1)
        u = r.random((B, S))
        for t in range(S):
            toks[:, t + 1] = (cdf[toks[:, t]] > u[:, t:t + 1]).argmax(-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class SyntheticSeq2SeqDataset:
    """Frame embeddings -> token transcripts (whisper-style backbone):
    ``frames`` (B, enc_len, d) f32, ``tokens`` and ``labels`` (B,
    dec_len) i32, the tokens the labels after a start token 0."""

    d_model: int
    vocab: int
    enc_len: int
    dec_len: int
    batch: int
    seed: int = 0
    effective_vocab: int = 128

    def __post_init__(self):
        r = np.random.default_rng(self.seed)
        k = min(self.effective_vocab, self.vocab)
        self.readout = r.normal(size=(self.d_model, k)).astype(np.float32)
        self.k = k

    def batch_at(self, step: int):
        r = _rng(self.seed, step)
        frames = r.normal(size=(self.batch, self.enc_len,
                                self.d_model)).astype(np.float32)
        # pooled frame windows determine the target tokens (a learnable
        # alignment)
        pool = (self.enc_len // self.dec_len
                if self.enc_len >= self.dec_len else 1)
        trimmed = frames[:, :pool * self.dec_len].reshape(
            self.batch, self.dec_len, pool, self.d_model).mean(2)
        scores = trimmed @ self.readout
        labels = scores.argmax(-1).astype(np.int32)
        tokens = np.concatenate(
            [np.zeros((self.batch, 1), np.int32), labels[:, :-1]], axis=1)
        return {"frames": frames, "tokens": tokens, "labels": labels}


@dataclass
class SyntheticVLMDataset:
    """Patch-embedding prefix + Markov text (internvl-style early fusion):
    ``patches`` (B, n_patches, d) f32 beside the text's ``tokens`` and
    ``labels`` (B, text_len)."""

    d_model: int
    vocab: int
    n_patches: int
    text_len: int
    batch: int
    seed: int = 0

    def __post_init__(self):
        self.lm = SyntheticLMDataset(self.vocab, self.text_len, self.batch,
                                     seed=self.seed)

    def batch_at(self, step: int):
        r = _rng(self.seed, step)
        out = self.lm.batch_at(step)
        out["patches"] = r.normal(
            size=(self.batch, self.n_patches, self.d_model)
        ).astype(np.float32)
        return out


def make_dataset(cfg, *, seq_len: int, batch: int, seed: int = 0,
                 var_len: bool = False, bucket: bool = False):
    """The family's synthetic dataset for an ArchConfig: utterances (lstm;
    ``var_len``/``bucket`` select variable lengths, for that family
    alone), frames and transcripts of seq_len // 2 each (encdec), a
    ``vlm_patch_frac`` share of seq_len as patches before the text (vlm),
    else token streams of seq_len."""
    fam = cfg.family
    if (var_len or bucket) and fam != "lstm":
        raise ValueError(f"var_len/bucket batching is only defined for the "
                         f"lstm (utterance) family, not {fam!r}")
    if fam == "lstm":
        return SyntheticASRDataset(cfg.input_dim, cfg.vocab, seq_len, batch,
                                   seed=seed, var_len=var_len or bucket,
                                   bucket=bucket)
    if fam == "encdec":
        half = seq_len // 2
        return SyntheticSeq2SeqDataset(cfg.d_model, cfg.vocab, half, half,
                                       batch, seed=seed)
    if fam == "vlm":
        sp = int(seq_len * cfg.vlm_patch_frac)
        return SyntheticVLMDataset(cfg.d_model, cfg.vocab, sp, seq_len - sp,
                                   batch, seed=seed)
    return SyntheticLMDataset(cfg.vocab, seq_len, batch, seed=seed)


class Prefetcher:
    """Host-side prefetch thread: overlaps batch synthesis with the device
    step, the way the paper overlaps data loading with gradient compute
    (§IV-D 'run data loaders in multiple processes') — an own copy of
    ``repro.data.pipeline.Prefetcher``.

    Exceptions raised inside the worker are captured and re-raised from
    :meth:`next` (after any already-synthesized batches drain), so a
    consumer never blocks forever on a dead worker; :meth:`close` joins
    the worker thread (bounded by ``join_timeout``)."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2,
                 join_timeout: float = 5.0):
        self.dataset = dataset
        self.q = queue.Queue(maxsize=depth)
        self.step = start_step
        self.join_timeout = join_timeout
        self.stop = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        s = self.step
        while not self.stop.is_set():
            try:
                batch = self.dataset.batch_at(s)
            except BaseException as e:       # re-raised on the consumer side
                self.error = e
                return
            while not self.stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    s += 1
                    break
                except queue.Full:
                    continue

    def next(self):
        while True:
            try:
                return self.q.get(timeout=0.5)
            except queue.Empty:
                if self.error is not None:
                    raise RuntimeError(
                        "prefetch worker failed") from self.error
                if not self.thread.is_alive():
                    raise RuntimeError("prefetch worker exited unexpectedly")

    def close(self):
        self.stop.set()
        self.thread.join(timeout=self.join_timeout)
