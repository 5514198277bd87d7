"""The port's LM servers serving the moe family on the CPU at the reduced
``granite-moe-3b-a800m`` width (4 experts of d_ff 128, top-2, the dense
router): the reference's serving contracts within the port, bit for bit —
batched ≡ sequential, preempt/restore ≡ uninterrupted, ``reset``, typed
``pool_full`` — over the dense KV cache of :class:`Server` and the page
pool of :class:`PagedServer`, which admits the moe family as the
reference's paged layout admits every attention-only family.  The CLI
serves ``--arch granite-moe-3b-a800m`` (dense and paged) and the reduced
``llama4-scout-17b-a16e`` (the dispatch router), and refuses the full
llama4 width: its weights do not fit one card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention, moe_dense  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.serving.admission import OK, POOL_FULL  # noqa: E402

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"


def _cfg(name=GRANITE):
    return get_arch(name).reduced()


def _server(name=GRANITE, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 128)
    return TS.Server(_cfg(name), device="cpu", **kw)


def _paged(**kw):
    kw.setdefault("pool_pages", 96)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 128)
    return TS.PagedServer(_cfg(), device="cpu", **kw)


def _prompts(lengths, seed=0, shared=0, name=GRANITE):
    return [p for _, p in TS.lm_requests(_cfg(name), lengths, seed=seed,
                                         shared_prefix=shared)]


def _serve(server, prompts, max_new):
    finished, _, _, _ = TS.serve_lm(server, list(enumerate(prompts)),
                                    max_new)
    return dict(finished)


def test_cache_is_kv_only():
    s = _server(slots=2)
    cfg = _cfg()
    assert set(s.cache) == {"attn"}
    k = s.cache["attn"]["k"]
    assert tuple(k.shape) == (cfg.n_layers, 2, 128, cfg.n_kv_heads,
                              cfg.head_dim) and k.dtype == torch.bfloat16
    assert set(s.params["layers"]) == {"ln1", "attn", "ln2", "moe"}


def test_admit_writes_its_slot_on_the_plain_path():
    s = _server(slots=2)
    prompt = _prompts([70])[0]
    before = (moe_dense.launches, flash_attention.launches)
    r = s.admit(7, prompt, 4)
    assert r and r.reason == OK and r.slot == 0
    _, row = s.model.prefill_fn(s.params, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int32))}, cache_len=128)
    for name in ("k", "v"):
        assert torch.equal(s.cache["attn"][name][:, 0],
                           row["attn"][name][:, 0])
        assert not s.cache["attn"][name][:, 1].any()
    # the CPU runs the plain versions
    assert (moe_dense.launches, flash_attention.launches) == before


def test_batched_step_matches_sequential_bit_for_bit():
    """Equal prompt lengths put several slots at one position, so waves
    decode groups of 2-3 — contiguous slots on cache views, and slots 0
    and 2 through the gather/scatter path — and must give the per-slot
    decode's tokens exactly: under the dense router a token's MoE output
    does not depend on the tokens routed beside it."""
    prompts = _prompts([5, 70, 5, 1, 5, 2, 70, 20])

    def run(batched):
        return _serve(_server(batched=batched), prompts, 6)

    batched, sequential = run(True), run(False)
    assert batched == sequential and len(batched) == len(prompts)
    assert all(len(t) == 6 for t in batched.values())


@pytest.mark.parametrize("batched", [True, False])
def test_dispatch_router_serves_to_completion(batched):
    """The reduced llama4-scout (top-1 of 4 experts, capacity factor 1.25,
    a shared expert) serves every request its tokens, batched or not.
    Its capacity routing makes the tokens of one call compete for expert
    slots (a group of 2-3 decoding tokens has cap 1), as in the
    reference, so batched and sequential runs may decode apart."""
    prompts = _prompts([5, 70, 5, 1, 5, 2, 70, 20], name=LLAMA4)
    out = _serve(_server(LLAMA4, batched=batched), prompts, 6)
    assert sorted(out) == list(range(len(prompts)))
    assert all(len(t) == 6 and all(0 <= x < _cfg(LLAMA4).vocab for x in t)
               for t in out.values())


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
    assert not s.cache["attn"]["k"].any()
    assert s.restore(snap)                       # resumes after reset


def test_paged_server_decodes_the_dense_servers_tokens():
    """A shared 8-token prefix (two full pages of 4) and prompts of any
    length: the page pool serves the moe family and its outputs equal the
    dense server's, bit for bit; every page returns to the pool."""
    prompts = _prompts([11, 30, 9, 70, 13], shared=8)
    dense = _serve(_server(), prompts, 6)
    paged_server = _paged()
    paged = _serve(paged_server, prompts, 6)
    assert paged == dense and len(paged) == len(prompts)
    assert paged_server.pool.n_shared_hits > 0
    assert paged_server.pool.pages_in_use == 0


def test_paged_preempt_resume_bit_exact():
    prompts = _prompts([10, 23], shared=8)

    def run(preempt_at):
        s = _paged()
        s.admit(0, prompts[0], 8)
        s.admit(1, prompts[1], 8)
        fin = []
        for i in range(30):
            if i == preempt_at:
                snap = s.preempt(0)
                fin += s.step()
                assert s.restore(snap)
            fin += s.step()
            if not s.reqs:
                break
        return dict(fin)

    assert run(-1) == run(3)


def test_cli_serves_granite_on_the_cpu(capsys):
    TS.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 15 tokens" in out


def test_cli_serves_granite_paged_on_the_cpu(capsys):
    TS.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
             "--requests", "3", "--slots", "2", "--max-new", "5",
             "--cache", "paged", "--page-size", "4", "--shared-prefix", "6"])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 15 tokens" in out
    assert "[kv] pool=" in out


def test_cli_serves_reduced_llama4_and_refuses_its_full_width(capsys):
    TS.main(["--arch", LLAMA4, "--reduced", "--device", "cpu",
             "--requests", "2", "--slots", "2", "--max-new", "4",
             "--prompt-len", "70", "--max-len", "96"])
    assert "served 2 requests on cpu, 8 tokens" in capsys.readouterr().out
    for extra in ([], ["--cache", "paged"]):
        with pytest.raises(SystemExit):
            TS.main(["--arch", LLAMA4, "--device", "cpu"] + extra)
        err = capsys.readouterr().err
        assert "GB of weights do not fit one 80 GB card" in err


def test_weights_fit_follows_the_card_in_use(monkeypatch):
    """On a CUDA device the limit is that card's own memory: the full-width
    granite's 6.6 GB fit an H100 (and the CPU's stand-in for one) but not
    a 4 GB card."""
    from repro_torch.models import build_model

    class Props:
        total_memory = 4e9

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    model = build_model(get_arch(GRANITE))
    with pytest.raises(ValueError, match="do not fit one 4 GB card"):
        TS.require_weights_fit(model, torch.device("cuda"))
    TS.require_weights_fit(model, torch.device("cpu"))
