"""Refcounted KV-cache page pool with prompt-prefix sharing and COW.

The dense LM server pins one ``(L, max_len, KV, E)`` cache row per slot,
so a 16-token request holds the same HBM as an 8192-token one.  This
module is the host-side bookkeeping that fixes that: the physical cache
becomes a fixed pool of **pages** (``page_size`` cache positions each)
and every request owns a small *page table* mapping its logical pages to
physical ones (docs/serving.md §KV paging).

Three mechanisms, all pure host-side Python (no device state — the
server owns the device page arrays and applies the copy/scatter actions
this module returns):

* **Refcounted allocation.**  ``alloc_request`` reserves
  ``ceil(total_positions / page_size)`` pages up front (eager: a request
  that admits can never OOM mid-decode).  ``free_request`` drops one
  refcount per table entry; a page returns to the free list when its
  refcount hits zero.  The free list is LIFO and deterministically
  seeded, so allocation order is reproducible.
* **Prefix sharing.**  A chained-hash trie maps ``digest(tokens[:n])``
  to the physical page holding positions ``[(n-1)//P * P, n)``.  At
  admission the pool probes the trie page by page; every hit shares the
  existing physical page (refcount += 1) instead of allocating a fresh
  one.  Digests are registered for *every* prefix length covered by an
  owned prompt page, so a shorter prompt can share the partial tail
  page of a longer identical prefix.
* **Copy-on-write.**  Before the server writes position ``pos`` it calls
  ``ensure_writable``; if the page holding ``pos`` is shared
  (refcount > 1) the pool moves the request onto a fresh page and
  returns ``(old, new)`` so the server copies the device page.  A
  shared *partial* page is guaranteed a COW page at admission time
  (``reserved`` pages), so admission is still all-or-nothing.  A sole
  owner writing into its own registered prompt page instead *trims* the
  trie so no later request can share beyond the overwritten prefix.

Safety of partial-page sharing: a sharer with prompt length ``p`` only
ever attends positions ``< pos`` with ``pos`` starting at ``p``, i.e.
entirely inside the verified-identical prefix; the original owner's
writes land at positions ``>= its own p' >= p`` and trigger COW/trim
first.  Digest collisions (blake2b-128 chained per token) are assumed
impossible, as in vLLM's block-hash sharing.

Telemetry: ``pages_in_use``, ``sharing_ratio`` (fraction of logical
pages backed by a shared physical page), ``n_cow``, ``n_shared_hits``.
``check()`` asserts the pool invariants (refcounts sum to table refs,
free + in-use partitions the pool, reservations are backed by free
pages) and is hammered by a hypothesis property test.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _digest_chain(prev: bytes, token: int) -> bytes:
    """Chained 128-bit prefix digest: h_n = H(h_{n-1} || token_n)."""
    return hashlib.blake2b(
        prev + int(token).to_bytes(8, "little", signed=True),
        digest_size=16).digest()


def prefix_digests(tokens, lo: int = 0, prev: bytes = b""):
    """Digests ``h_{lo+1} .. h_{len(tokens)}`` of the token chain,
    starting from ``prev = h_lo``.  ``h_n`` covers ``tokens[:n]``."""
    out = []
    h = prev
    for t in tokens[lo:]:
        h = _digest_chain(h, t)
        out.append(h)
    return out


@dataclass
class PageAlloc:
    """Result of a successful :meth:`PagePool.alloc_request`."""

    table: list          # physical page id per logical page
    owned: list          # bool per logical page; False = trie-shared
    n_shared: int = 0    # logical pages backed by a shared physical page

    @property
    def n_pages(self) -> int:
        return len(self.table)


@dataclass
class _Request:
    prompt: tuple
    total: int           # total cache positions reserved (incl. decode)
    table: list = field(default_factory=list)
    owned: list = field(default_factory=list)
    reserved: int = 0    # free pages held back for a pending COW
    reserved_for: int = -1   # physical page the reservation is tied to


class PagePool:
    """Fixed pool of ``n_pages`` physical KV pages of ``page_size``
    positions each; see module docstring for the contract."""

    def __init__(self, n_pages: int, page_size: int, *, seed: int = 0,
                 share: bool = True):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.share = bool(share)
        self.seed = int(seed)
        self.n_cow = 0
        self.n_shared_hits = 0
        self.refcount = np.zeros(self.n_pages, dtype=np.int64)
        order = np.arange(self.n_pages)
        if seed:
            order = np.random.default_rng(seed).permutation(order)
        # LIFO free list: pop() from the tail → page order[ -1 ] first.
        self._free = [int(p) for p in order[::-1]]
        self._reqs: dict[int, _Request] = {}
        # digest -> physical page;  page -> [(prefix_len, digest), ...]
        self._trie: dict[bytes, int] = {}
        self._registered: dict[int, list] = {}

    # -- telemetry ---------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    @property
    def total_refs(self) -> int:
        return int(self.refcount.sum())

    @property
    def reserved_pages(self) -> int:
        return sum(r.reserved for r in self._reqs.values())

    @property
    def free_pages(self) -> int:
        """Pages available to *new* admissions (excludes COW reserves)."""
        return len(self._free) - self.reserved_pages

    @property
    def sharing_ratio(self) -> float:
        """Fraction of logical page references served by a shared
        physical page: ``1 - pages_in_use / total_refs`` (0 when idle)."""
        refs = self.total_refs
        return 0.0 if refs == 0 else 1.0 - self.pages_in_use / refs

    def table_of(self, rid: int):
        return list(self._reqs[rid].table)

    def owned_of(self, rid: int):
        return list(self._reqs[rid].owned)

    # -- alloc / share -----------------------------------------------------
    def pages_for(self, total_positions: int) -> int:
        """Worst-case (no-sharing) page demand of a request reserving
        ``total_positions`` cache positions."""
        return cdiv(int(total_positions), self.page_size)

    def alloc_request(self, rid: int, prompt, total_positions: int, *,
                      written_upto: int = None):
        """Reserve pages for ``total_positions`` cache positions, sharing
        prompt-prefix pages against the trie.  Returns a
        :class:`PageAlloc` or ``None`` when the pool lacks free pages
        (retryable — the typed ``pool_full``).  ``written_upto`` (restore
        path) marks positions ``[0, written_upto)`` as already holding
        data; pages containing *decode* output are never shared."""
        if rid in self._reqs:
            raise KeyError(f"rid {rid} already allocated")
        P = self.page_size
        prompt = tuple(int(t) for t in prompt)
        plen = len(prompt)
        total = int(total_positions)
        if not plen or total < plen:
            raise ValueError("need total_positions >= len(prompt) >= 1")
        pos = plen if written_upto is None else int(written_upto)
        # Only verified prompt content is shareable; a partial page that
        # already holds decode output (pos > plen) is not.
        share_upto = plen if pos <= plen else P * (plen // P)
        n_total = cdiv(total, P)

        table, owned = [], []
        shared_partial = 0
        if self.share:
            h = b""
            for j in range(n_total):
                e = min((j + 1) * P, share_upto)
                if e <= j * P:
                    break
                h = prefix_digests(prompt, lo=j * P, prev=h)[e - j*P - 1]
                hit = self._trie.get(h)
                if hit is None:
                    break
                table.append(hit)
                owned.append(False)
                if e < (j + 1) * P:      # partial page ⇒ COW guaranteed
                    shared_partial = 1
        n_shared = len(table)
        need = (n_total - n_shared) + shared_partial
        if need > self.free_pages:
            return None                   # pool_full (retryable)
        for p in table:
            self.refcount[p] += 1
        fresh = [self._free.pop() for _ in range(n_total - n_shared)]
        for p in fresh:
            self.refcount[p] = 1
            table.append(p)
            owned.append(True)
        self.n_shared_hits += n_shared
        req = _Request(prompt=prompt, total=total, table=table,
                       owned=owned, reserved=shared_partial,
                       reserved_for=table[n_shared - 1]
                       if shared_partial else -1)
        self._reqs[rid] = req
        # Register prefix digests for *owned* prompt pages so later
        # identical prefixes can share them.
        if self.share:
            for j in range(n_shared, n_total):
                e = min((j + 1) * P, share_upto)
                if e <= j * P:
                    break
                self._register(table[j], prompt, j * P, e)
        return PageAlloc(table=list(table), owned=list(owned),
                         n_shared=n_shared)

    def _register(self, page: int, prompt, lo: int, hi: int):
        prev = b""
        if lo:
            prev = prefix_digests(prompt[:lo])[-1]
        regs = self._registered.setdefault(page, [])
        for n, h in enumerate(prefix_digests(prompt[:hi], lo=lo, prev=prev),
                              start=lo + 1):
            if h not in self._trie:        # first writer wins
                self._trie[h] = page
                regs.append((n, h))

    def _unregister(self, page: int, keep_upto: int = -1):
        """Drop this page's trie entries with prefix_len > keep_upto."""
        regs = self._registered.get(page, [])
        kept = []
        for n, h in regs:
            if n <= keep_upto:
                kept.append((n, h))
            elif self._trie.get(h) == page:
                del self._trie[h]
        if kept:
            self._registered[page] = kept
        else:
            self._registered.pop(page, None)

    # -- write / COW -------------------------------------------------------
    def ensure_writable(self, rid: int, pos: int):
        """Called before the server writes cache position ``pos``.
        Returns ``(old_page, new_page)`` when a copy-on-write happened
        (the caller must copy the device page old → new), else ``None``.
        A sole owner writing inside a registered prompt page trims the
        trie so stale prefixes can no longer be shared."""
        req = self._reqs[rid]
        P = self.page_size
        pos = int(pos)
        if not (0 <= pos < req.total):
            raise IndexError(f"pos {pos} outside reserved [0, {req.total})")
        j = pos // P
        phys = req.table[j]
        if self.refcount[phys] > 1:
            # Consume a COW reservation TIED TO THIS PHYSICAL PAGE.  The
            # writer may be the page's original owner (which never
            # reserves) while a partial sharer holds the reservation —
            # any reservation on ``phys`` is interchangeable: each COW
            # drops the refcount by one, so refcount-1 pending writes
            # are covered by the refcount-1 sharer reservations.
            donor = req if (req.reserved and req.reserved_for == phys) \
                else next((r for r in self._reqs.values()
                           if r.reserved and r.reserved_for == phys),
                          None)
            if donor is not None:
                donor.reserved = 0
                donor.reserved_for = -1
            elif self.free_pages <= 0:
                raise RuntimeError("COW with no unreserved free page — "
                                   "shared partial pages must reserve one "
                                   "at admission")
            new = self._free.pop()
            self.refcount[phys] -= 1
            self.refcount[new] = 1
            req.table[j] = new
            req.owned[j] = True
            self.n_cow += 1
            return (phys, new)
        # Sole owner: an in-place write at ``pos`` invalidates every
        # registered prefix longer than ``pos`` on this page.  A now-
        # unneeded reservation (every other sharer already left or
        # COWed away) is released back to the admittable budget.
        if req.reserved and req.reserved_for == phys:
            req.reserved = 0
            req.reserved_for = -1
        self._unregister(phys, keep_upto=pos)
        return None

    # -- free --------------------------------------------------------------
    def free_request(self, rid: int):
        """Release the request's table: one refcount each; pages return
        to the free list (and leave the trie) at refcount zero."""
        req = self._reqs.pop(rid)
        for phys in req.table:
            self.refcount[phys] -= 1
            if self.refcount[phys] == 0:
                self._unregister(phys)
                self._free.append(phys)

    def reset(self):
        """Drain the pool: every request freed, free list re-seeded."""
        for rid in list(self._reqs):
            self.free_request(rid)
        assert self.pages_in_use == 0 and not self._trie
        order = np.arange(self.n_pages)
        if self.seed:
            order = np.random.default_rng(self.seed).permutation(order)
        self._free = [int(p) for p in order[::-1]]

    # -- invariants --------------------------------------------------------
    def check(self):
        """Assert pool invariants; returns self (chainable in tests)."""
        assert (self.refcount >= 0).all(), "negative refcount"
        in_use = {p for p in range(self.n_pages) if self.refcount[p] > 0}
        free = set(self._free)
        assert len(self._free) == len(free), "duplicate page in free list"
        assert not (in_use & free), "page both free and referenced"
        assert len(in_use) + len(free) == self.n_pages, "leaked page"
        refs = sum(len(r.table) for r in self._reqs.values())
        assert refs == self.total_refs, "refcounts != sum of table refs"
        assert self.reserved_pages <= len(self._free), \
            "COW reservation not backed by a free page"
        for r in self._reqs.values():
            assert r.reserved in (0, 1), "at most one COW reserve/request"
            assert not r.reserved or r.reserved_for in r.table, \
                "reservation tied to a page outside the request's table"
        for h, p in self._trie.items():
            assert self.refcount[p] > 0, "trie entry on a free page"
            assert any(hh == h for _, hh in self._registered.get(p, [])), \
                "trie entry missing from page registry"
        return self
