"""The port's LM ``Server`` serving the ssm family on the CPU at the
reduced ``mamba2-370m`` width: the reference's serving contracts within
the port, bit for bit — batched ≡ sequential, preempt/restore ≡
uninterrupted, ``reset``, typed ``pool_full``/``no_budget``/
``prompt_too_long`` — plus what the ssm family adds: prompts of any
length are admitted (a ragged last SSD chunk), the decode state rows move
whole between slots, the paged server refuses the family, and the CLI
serves ``--arch mamba2-370m``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving.admission import (NO_BUDGET, OK, POOL_FULL,  # noqa: E402
                                           PROMPT_TOO_LONG)


def _cfg():
    return get_arch("mamba2-370m").reduced()


def _server(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 48)
    return TS.Server(_cfg(), device="cpu", **kw)


def _prompts(lengths, seed=0):
    return [p for _, p in TS.lm_requests(_cfg(), lengths, seed=seed)]


def _serve(server, prompts, max_new):
    finished, _, _, _ = TS.serve_lm(server, list(enumerate(prompts)),
                                    max_new)
    return dict(finished)


def test_cache_is_the_ssm_state_tree():
    s = _server(slots=2)
    cfg = _cfg()
    assert set(s.cache) == {"ssm"}
    h = s.cache["ssm"]["h"]
    assert tuple(h.shape) == (cfg.n_layers, 2, 32, cfg.ssm.state_dim,
                              cfg.ssm.head_dim) and h.dtype == torch.float32
    cx = s.cache["ssm"]["conv"]["x"]
    assert tuple(cx.shape) == (cfg.n_layers, 2, cfg.ssm.conv_width - 1,
                               2 * cfg.d_model)
    assert cx.dtype == torch.bfloat16


def test_typed_admit_branches():
    s = _server(slots=1, max_len=8)
    r = s.admit(0, np.arange(10), 4)
    assert not r and r.reason == PROMPT_TOO_LONG
    r = s.admit(0, np.arange(3), 0)
    assert not r and r.reason == NO_BUDGET
    r = s.admit(0, np.arange(3), 4)
    assert r and r.reason == OK and r.slot == 0
    r = s.admit(1, np.arange(3), 4)
    assert not r and r.reason == POOL_FULL
    assert [k for k, _, _ in s.events] == ["reject", "reject", "admit"]


def test_admit_writes_the_prefill_state_into_its_slot():
    """Admission scatters every leaf of the prefill's state into the slot's
    row and leaves the other rows untouched; a ragged prompt (20 tokens at
    chunk 16, which the reference's Pallas path refuses) is admitted."""
    s = _server(slots=2)
    prompt = _prompts([20])[0]
    assert s.admit(7, prompt, 4).slot == 0
    _, row = s.model.prefill_fn(s.params, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int32))})
    assert torch.equal(s.cache["ssm"]["h"][:, 0], row["ssm"]["h"][:, 0])
    for k in ("x", "B", "C"):
        assert torch.equal(s.cache["ssm"]["conv"][k][:, 0],
                           row["ssm"]["conv"][k][:, 0])
    assert not s.cache["ssm"]["h"][:, 1].any()
    assert ssd_scan.launches == 0          # the CPU runs the plain version


def test_batched_step_matches_sequential_bit_for_bit():
    """Equal prompt lengths put several slots at one position, so waves
    decode groups of 2-3 — contiguous slots on cache views and slots 0
    and 2 through the gather/scatter path — and must give the per-slot
    decode's tokens exactly.  Lengths 1, 2 (shorter than the conv window)
    and 20 (a ragged chunk) are among them."""
    prompts = _prompts([5, 20, 5, 1, 5, 2, 20])

    def run(batched):
        return _serve(_server(batched=batched), prompts, 6)

    batched, sequential = run(True), run(False)
    assert batched == sequential and len(batched) == len(prompts)
    assert all(len(t) == 6 for t in batched.values())


def test_gathered_group_replaces_its_rows_only():
    """A non-contiguous group (slots 0 and 2) writes its whole state rows
    back and leaves slot 1's rows untouched."""
    s = _server()
    for rid, p in enumerate(_prompts([5, 7, 5])):
        assert s.admit(rid, p, 4)
    before = {k: v[:, 1].clone() for k, v in s.cache["ssm"]["conv"].items()}
    h1 = s.cache["ssm"]["h"][:, 1].clone()
    h02 = s.cache["ssm"]["h"][:, [0, 2]].clone()
    s._decode([0, 2], 5)
    assert torch.equal(s.cache["ssm"]["h"][:, 1], h1)
    for k, v in before.items():
        assert torch.equal(s.cache["ssm"]["conv"][k][:, 1], v)
    assert not torch.equal(s.cache["ssm"]["h"][:, [0, 2]], h02)


def test_preempt_resume_bit_exact():
    prompts = _prompts([5, 9])

    def run(preempt_at):
        s = _server(slots=2)
        s.admit(0, prompts[0], 8)
        s.admit(1, prompts[1], 8)
        fin = []
        for i in range(30):
            if i == preempt_at:
                snap = s.preempt(0)
                assert snap["row"]["ssm"]["h"].device.type == "cpu"
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
    s = _server(slots=1)
    assert s.admit(0, prompts[0], 8)
    with pytest.raises(KeyError):
        s.preempt(99)
    snap = s.preempt(0)
    assert s.admit(1, prompts[1], 8)
    assert s.restore(snap).reason == POOL_FULL
    s.reset()
    assert not s.active.any() and s.events == []
    assert not s.cache["ssm"]["h"].any()
    assert not s.cache["ssm"]["conv"]["x"].any()
    assert s.restore(snap)                       # resumes after reset
    assert torch.equal(s.cache["ssm"]["h"][:, 0],
                       snap["row"]["ssm"]["h"][:, 0])


def test_paged_server_refuses_the_ssm_family(capsys):
    with pytest.raises(ValueError, match="attention-only family, got ssm"):
        TS.PagedServer(_cfg(), pool_pages=8, page_size=4, max_len=16,
                       device="cpu")
    with pytest.raises(SystemExit):
        TS.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                 "--cache", "paged"])
    assert "attention-only family, got ssm" in capsys.readouterr().err


def test_cli_serves_mamba2_on_cpu(capsys):
    TS.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--max-new", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 24 tokens" in out
    assert out.count("[req] done") == 3
