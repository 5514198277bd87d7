"""The port's LM ``Server`` serving the hybrid family on the CPU at the
reduced ``hymba-1.5b`` width: the reference's serving contracts within
the port, bit for bit — batched ≡ sequential, preempt/restore ≡
uninterrupted, ``reset``, typed ``pool_full`` — over a cache that holds
both halves, the KV rows and the SSM states.  A group of slots that is
not contiguous decodes on gathered rows and writes back both what the
step wrote: its new KV column and its whole SSM rows.  Prompts past the
64-position window and of any length are admitted; the paged server
refuses the family; the CLI serves ``--arch hymba-1.5b``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving.admission import OK, POOL_FULL  # noqa: E402


def _cfg():
    return get_arch("hymba-1.5b").reduced()


def _server(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 128)
    return TS.Server(_cfg(), device="cpu", **kw)


def _prompts(lengths, seed=0):
    return [p for _, p in TS.lm_requests(_cfg(), lengths, seed=seed)]


def _serve(server, prompts, max_new):
    finished, _, _, _ = TS.serve_lm(server, list(enumerate(prompts)),
                                    max_new)
    return dict(finished)


def test_cache_holds_both_halves():
    s = _server(slots=2)
    cfg = _cfg()
    assert set(s.cache) == {"attn", "ssm"}
    k = s.cache["attn"]["k"]
    assert tuple(k.shape) == (cfg.n_layers, 2, 128, cfg.n_kv_heads,
                              cfg.head_dim) and k.dtype == torch.bfloat16
    h = s.cache["ssm"]["h"]
    assert tuple(h.shape) == (cfg.n_layers, 2, 32, cfg.ssm.state_dim,
                              cfg.ssm.head_dim) and h.dtype == torch.float32


def test_admit_writes_both_halves_into_its_slot():
    """A 100-token prompt (past the window, a ragged SSD chunk) lands in
    slot 0: its prefill's KV rows and SSM state, every other row zero."""
    s = _server(slots=2)
    prompt = _prompts([100])[0]
    r = s.admit(7, prompt, 4)
    assert r and r.reason == OK and r.slot == 0
    _, row = s.model.prefill_fn(s.params, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int32))}, cache_len=128)
    for name in ("k", "v"):
        assert torch.equal(s.cache["attn"][name][:, 0],
                           row["attn"][name][:, 0])
        assert not s.cache["attn"][name][:, 1].any()
        assert not s.cache["attn"][name][:, 0, 100:].any()
    assert torch.equal(s.cache["ssm"]["h"][:, 0], row["ssm"]["h"][:, 0])
    for k in ("x", "B", "C"):
        assert torch.equal(s.cache["ssm"]["conv"][k][:, 0],
                           row["ssm"]["conv"][k][:, 0])
    assert not s.cache["ssm"]["h"][:, 1].any()
    # the CPU runs the plain versions
    assert flash_attention.launches == 0 and ssd_scan.launches == 0


def test_batched_step_matches_sequential_bit_for_bit():
    """Equal prompt lengths put several slots at one position, so waves
    decode groups of 2-3 — contiguous slots on cache views, and slots 0
    and 2 through the gather/scatter path — and must give the per-slot
    decode's tokens exactly.  Lengths 1 and 2 are shorter than the conv
    window, 20 and 70 leave ragged chunks, 70 runs past the window."""
    prompts = _prompts([5, 70, 5, 1, 5, 2, 70, 20])

    def run(batched):
        return _serve(_server(batched=batched), prompts, 6)

    batched, sequential = run(True), run(False)
    assert batched == sequential and len(batched) == len(prompts)
    assert all(len(t) == 6 for t in batched.values())


def test_gathered_group_writes_its_column_and_rows_only():
    """A non-contiguous group (slots 0 and 2) writes its new KV column at
    ``pos`` and its whole SSM rows back, and leaves slot 1 untouched."""
    s = _server()
    for rid, p in enumerate(_prompts([5, 7, 5])):
        assert s.admit(rid, p, 4)
    before = {n: v.clone() for n, v in s.cache["attn"].items()}
    conv1 = {k: v[:, 1].clone() for k, v in s.cache["ssm"]["conv"].items()}
    h = s.cache["ssm"]["h"].clone()
    s._decode([0, 2], 5)
    for n, old in before.items():
        new = s.cache["attn"][n]
        assert torch.equal(new[:, 1], old[:, 1])
        assert torch.equal(new[:, [0, 2], :5], old[:, [0, 2], :5])
        assert not old[:, [0, 2], 5].any()
        assert new[:, [0, 2], 5].abs().sum() > 0
        assert not new[:, [0, 2], 6:].any()
    assert torch.equal(s.cache["ssm"]["h"][:, 1], h[:, 1])
    for k, v in conv1.items():
        assert torch.equal(s.cache["ssm"]["conv"][k][:, 1], v)
    assert not torch.equal(s.cache["ssm"]["h"][:, [0, 2]], h[:, [0, 2]])


def test_preempt_resume_bit_exact():
    prompts = _prompts([5, 70])

    def run(preempt_at):
        s = _server(slots=2)
        s.admit(0, prompts[0], 8)
        s.admit(1, prompts[1], 8)
        fin = []
        for i in range(30):
            if i == preempt_at:
                snap = s.preempt(0)
                assert snap["row"]["attn"]["k"].device.type == "cpu"
                assert snap["row"]["ssm"]["h"].device.type == "cpu"
                fin += s.step()                  # rid 1 alone
                assert s.restore(snap)
            fin += s.step()
            if not s.active.any():
                break
        return dict(fin)

    base, pre = run(-1), run(2)
    assert base == pre and len(base) == 2


def test_restore_pool_full_and_reset():
    prompts = _prompts([5, 9])
    s = _server(slots=1)
    assert s.admit(0, prompts[0], 8)
    snap = s.preempt(0)
    assert s.admit(1, prompts[1], 8)
    assert s.restore(snap).reason == POOL_FULL
    s.reset()
    assert not s.active.any() and s.events == []
    assert not s.cache["attn"]["k"].any() and not s.cache["ssm"]["h"].any()
    assert s.restore(snap)                       # resumes after reset
    assert torch.equal(s.cache["attn"]["v"][:, 0],
                       snap["row"]["attn"]["v"][:, 0])
    assert torch.equal(s.cache["ssm"]["h"][:, 0],
                       snap["row"]["ssm"]["h"][:, 0])


def test_paged_server_refuses_the_hybrid_family(capsys):
    with pytest.raises(ValueError,
                       match="attention-only family, got hybrid"):
        TS.PagedServer(_cfg(), pool_pages=8, page_size=4, max_len=16,
                       device="cpu")
    with pytest.raises(SystemExit):
        TS.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                 "--cache", "paged"])
    assert "attention-only family, got hybrid" in capsys.readouterr().err


def test_cli_serves_hymba_on_cpu(capsys):
    TS.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--max-new", "8",
             "--prompt-len", "70", "--max-len", "96"])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 24 tokens" in out
    assert out.count("[req] done") == 3
