"""The port's LM servers (``repro_torch.launch.serve.Server`` and
``PagedServer``) on the CPU at the reduced ``smollm-360m`` width: the
reference's serving contracts within the port, bit for bit — batched ≡
sequential, paged ≡ dense, prefix-shared ≡ unshared, preempt/restore ≡
uninterrupted, typed ``pool_full``/``no_budget``/``prompt_too_long``, and
``reset`` — as ``tests/test_serving.py`` and ``tests/test_paged_serving.py``
hold them for the JAX package; and the port's own copy of ``PagePool``
driven beside ``repro.serving.kvpool.PagePool``.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import kvpool as JK  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving import kvpool as TK  # noqa: E402
from repro_torch.serving.admission import (NO_BUDGET, OK, POOL_FULL,  # noqa: E402
                                           PROMPT_TOO_LONG)

ROOT = Path(__file__).resolve().parent.parent


def _cfg():
    return get_arch("smollm-360m").reduced()


def _dense(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    return TS.Server(_cfg(), device="cpu", **kw)


def _paged(**kw):
    kw.setdefault("pool_pages", 12)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 16)
    return TS.PagedServer(_cfg(), device="cpu", **kw)


def _prompts(lengths, shared=0, seed=0):
    return [p for _, p in TS.lm_requests(_cfg(), lengths,
                                         shared_prefix=shared, seed=seed)]


def _serve(server, prompts, max_new):
    finished, _, _, _ = TS.serve_lm(server, list(enumerate(prompts)),
                                    max_new)
    return dict(finished)


# ---------------------------------------------------------------------------
# dense Server
# ---------------------------------------------------------------------------

def test_typed_admit_branches():
    s = _dense(slots=1, max_len=8)
    r = s.admit(0, np.arange(10), 4)
    assert not r and r.reason == PROMPT_TOO_LONG
    r = s.admit(0, np.arange(3), 0)
    assert not r and r.reason == NO_BUDGET
    r = s.admit(0, np.arange(3), 4)
    assert r and r.reason == OK and r.slot == 0
    r = s.admit(1, np.arange(3), 4)
    assert not r and r.reason == POOL_FULL
    kinds = [k for k, _, _ in s.events]
    assert kinds == ["reject", "reject", "admit"]


def test_batched_step_matches_sequential_bit_for_bit():
    """Equal prompt lengths put several slots at one position, so waves
    decode groups of 2-3 — contiguous slots on cache views, and slots 0
    and 2 through the gather/scatter path — and must give the per-slot
    decode's tokens exactly."""
    prompts = _prompts([5, 9, 5, 7, 5, 9])

    def run(batched):
        return _serve(_dense(batched=batched), prompts, 6)

    batched, sequential = run(True), run(False)
    assert batched == sequential and len(batched) == len(prompts)
    assert all(len(t) == 6 for t in batched.values())


def test_gathered_group_writes_only_its_column():
    """A non-contiguous group (slots 0 and 2) writes its new column back
    into the shared cache and leaves the other slot's row untouched."""
    s = _dense()
    for rid, p in enumerate(_prompts([5, 7, 5])):
        assert s.admit(rid, p, 4)
    before = s.cache["attn"]["k"][:, 1].clone()
    s._decode([0, 2], 5)
    assert torch.equal(s.cache["attn"]["k"][:, 1], before)
    assert s.cache["attn"]["k"][:, [0, 2], 5].any()


def test_preempt_resume_bit_exact():
    prompts = _prompts([5, 9])

    def run(preempt_at):
        s = _dense(slots=2)
        s.admit(0, prompts[0], 8)
        s.admit(1, prompts[1], 8)
        fin = []
        for i in range(30):
            if i == preempt_at:
                snap = s.preempt(0)
                assert snap["row"]["attn"]["k"].device.type == "cpu"
                fin += s.step()                  # rid 1 alone
                assert s.restore(snap)
            fin += s.step()
            if not s.active.any():
                break
        return dict(fin)

    base, pre = run(-1), run(2)
    assert base == pre and len(base) == 2


def test_restore_pool_full_reset_and_unknown_rid():
    prompts = _prompts([5, 9])
    s = _dense(slots=1)
    assert s.admit(0, prompts[0], 8)
    with pytest.raises(KeyError):
        s.preempt(99)
    snap = s.preempt(0)
    assert s.admit(1, prompts[1], 8)
    assert s.restore(snap).reason == POOL_FULL
    s.reset()
    assert not s.active.any() and s.events == []
    assert not s.cache["attn"]["k"].any()
    assert s.restore(snap)                       # resumes after reset


def test_step_wave_contract():
    prompts = _prompts([5, 9])
    s = _dense(slots=2)
    assert s.emits_on_admit
    s.admit(0, prompts[0], 2)
    s.admit(1, prompts[1], 2)
    done, progressed, work = s.step_wave()
    assert progressed == [0, 1] and work == 2
    assert [rid for rid, _ in done] == [0, 1]    # budget exhausted


# ---------------------------------------------------------------------------
# PagedServer
# ---------------------------------------------------------------------------

def test_paged_outputs_equal_dense():
    prompts = _prompts([6, 6, 3, 9])
    dense = _serve(_dense(slots=4, max_len=16), prompts, 5)
    paged = _serve(_paged(pool_pages=16), prompts, 5)
    assert paged == dense and len(paged) == 4


def test_prefix_shared_equals_unshared():
    """Identical prompts whose shared prefix splits a page: the trie
    shares it, the first write COWs, and the tokens equal a pool that
    shares nothing."""
    prompts = _prompts([6, 6, 6], shared=6, seed=1)
    shared_srv = _paged()
    got = _serve(shared_srv, prompts, 4)
    assert shared_srv.peak_sharing > 0
    assert any(k == "cow" for k, _, _ in shared_srv.events)
    assert shared_srv.pool.n_shared_hits > 0
    unshared = _serve(_paged(share=False), prompts, 4)
    assert got == unshared
    outs = list(got.values())
    assert all(o == outs[0] for o in outs)


def test_shuffled_pool_seed_equals_default():
    prompts = _prompts([5, 5, 7], seed=2)
    a = _serve(_paged(), prompts, 4)
    shuffled = _paged()
    shuffled.pool = TK.PagePool(12, 4, seed=11)   # permuted free list only
    assert _serve(shuffled, prompts, 4) == a


def test_paged_preempt_restore_bit_exact():
    prompts = _prompts([6, 6], shared=6, seed=3)
    ref = _serve(_paged(), prompts, 5)
    server = _paged()
    for i, p in enumerate(prompts):
        assert server.admit(i, p, 5)
    done = dict(server.step())
    snap = server.preempt(1)
    assert 1 not in server.reqs and snap["pages_k"].device.type == "cpu"
    done.update(server.step())
    assert server.restore(snap)
    while server.active.any():
        done.update(server.step())
    assert done == ref


def test_paged_restore_into_full_pool():
    p0, p1 = _prompts([6, 6], seed=4)
    server = _paged(pool_pages=4)
    assert server.admit(0, p0, 6)        # 3 pages of 4 (total 12)
    snap = server.preempt(0)
    assert server.admit(1, p1, 6)        # takes 3 of 4 pages
    res = server.restore(snap)
    assert not res and res.reason == POOL_FULL
    server.preempt(1)
    assert server.restore(snap)
    while server.active.any():
        server.step()
    assert server.pool.pages_in_use == 0


def test_paged_typed_admission():
    server = _paged(pool_pages=3)
    long_prompt = _prompts([14], seed=5)[0]
    assert server.admit(0, long_prompt, 8).reason == NO_BUDGET   # 4 pages
    assert server.admit(1, long_prompt, 0).reason == NO_BUDGET
    too_long = _prompts([16], seed=5)[0]
    assert server.admit(2, too_long, 1).reason == PROMPT_TOO_LONG
    assert server.admit(3, _prompts([9], seed=6)[0], 3)
    res = server.admit(4, _prompts([9], seed=7)[0], 3)
    assert res.reason == POOL_FULL
    kinds = {(k, kw.get("reason")) for k, _, kw in server.events
             if k == "reject"}
    assert kinds == {("reject", NO_BUDGET), ("reject", PROMPT_TOO_LONG)}


def test_paged_reset_drains_pool():
    server = _paged()
    first = _serve(server, _prompts([6, 6], seed=10), 4)
    assert server.pool.pages_in_use == 0
    server.reset()
    assert not server.reqs and not server.events
    assert server.peak_sharing == 0.0 and not server.k_pages.any()
    assert _serve(server, _prompts([6, 6], seed=10), 4) == first


# ---------------------------------------------------------------------------
# the own copy of PagePool
# ---------------------------------------------------------------------------

def test_kvpool_copy_is_byte_equal_to_jax():
    mine = (ROOT / "src/repro_torch/serving/kvpool.py").read_bytes()
    assert mine == (ROOT / "src/repro/serving/kvpool.py").read_bytes()


def test_pagepool_copy_matches_jax_on_a_seeded_sequence():
    """One seeded sequence of admissions (shared and fresh prompts),
    writes (COW and trims), preemptions and frees, driven through both
    copies: identical tables, refcounts, telemetry and results."""
    rng = np.random.default_rng(0)
    pools = [JK.PagePool(20, 4, seed=5), TK.PagePool(20, 4, seed=5)]
    base = [int(t) for t in rng.integers(0, 50, size=10)]
    live, written, nxt = {}, {}, 0
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 11))
            prompt = base[:n] if rng.random() < 0.6 else [
                int(t) for t in rng.integers(0, 50, size=n)]
            total = n + int(rng.integers(0, 8))
            res = [p.alloc_request(nxt, prompt, total) for p in pools]
            assert (res[0] is None) == (res[1] is None)
            if res[0] is not None:
                assert res[0].table == res[1].table
                assert res[0].owned == res[1].owned
                assert res[0].n_shared == res[1].n_shared
                live[nxt], written[nxt] = total, n
            nxt += 1
        elif op == 1 and live:
            rid = list(live)[int(rng.integers(0, len(live)))]
            if written[rid] < live[rid]:
                got = [p.ensure_writable(rid, written[rid]) for p in pools]
                assert got[0] == got[1]
                written[rid] += 1
        elif op == 2 and live:
            rid = list(live)[int(rng.integers(0, len(live)))]
            for p in pools:
                p.free_request(rid)
            del live[rid], written[rid]
        a, b = pools
        np.testing.assert_array_equal(a.refcount, b.refcount)
        assert (a.pages_in_use, a.free_pages, a.n_cow, a.n_shared_hits,
                a.sharing_ratio) == (b.pages_in_use, b.free_pages, b.n_cow,
                                     b.n_shared_hits, b.sharing_ratio)
        for rid in live:
            assert a.table_of(rid) == b.table_of(rid)
        b.check()
    assert pools[1].n_cow > 0 and pools[1].n_shared_hits > 0
    assert TK.cdiv(9, 4) == JK.cdiv(9, 4) == 3
    assert TK.prefix_digests([3, 1, 4]) == JK.prefix_digests([3, 1, 4])


# ---------------------------------------------------------------------------
# the CLI's LM branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--sequential"],
                                   ["--cache", "paged", "--page-size", "4",
                                    "--shared-prefix", "6"]])
def test_cli_serves_lm_on_cpu(capsys, extra):
    TS.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-len", "16", "--max-new", "4", *extra])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 12 tokens" in out
    assert "tok/s, occupancy" in out
    if "paged" in extra:
        assert "[kv] pool=8 pages x 4 positions, peak sharing_ratio=" in out
