"""The port's streaming-ASR server held against ``repro.launch.serve`` on
the CPU, at a tiny width (1 BLSTM layer, hidden 32, vocab 32).

Both servers get the same utterances and, through ``from_jax_params``,
the same weights.  Parked logits agree at the bf16 tolerance (2e-2,
normalised).  Beam selections are compared on identical logits only:
near-uniform random-init posteriors make them fragile under bf16-level
differences.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving.admission import (NO_BUDGET, POOL_FULL,  # noqa: E402
                                           PROMPT_TOO_LONG)

TINY = dict(n_layers=1, lstm_hidden=32, lstm_bottleneck=16, input_dim=16,
            vocab=32, beam_width=3)


def _cfgs():
    return (dataclasses.replace(jax_get_arch("swb2000-blstm").reduced(),
                                **TINY),
            dataclasses.replace(get_arch("swb2000-blstm").reduced(), **TINY))


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((n, TINY["input_dim"])).astype(np.float32)
            for n in (11, 7, 14)]


def _servers(slots=2, **kw):
    jcfg, tcfg = _cfgs()
    js = JS.AsrServer(jcfg, slots=slots, max_frames=16, chunk=4, **kw)
    ts = TS.AsrServer(tcfg, slots=slots, max_frames=16, chunk=4,
                      device="cpu", **kw)
    ts.params = from_jax_params(jax.tree.map(np.asarray, js.params))
    return js, ts


def _drain(server, pending):
    finished, _ = TS.serve_all(server, pending)
    return dict(finished)


def test_parked_logits_match_jax(feats):
    js, ts = _servers()
    for rid in (0, 1):
        assert js.admit(rid, feats[rid]) and ts.admit(rid, feats[rid])
    want = js.logits[:2]
    got = ts.logits[:2].numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) / scale <= 2e-2


@pytest.mark.parametrize("topc", [0, 8])
def test_decode_of_jax_logits_matches_jax(feats, topc):
    """The port's beam decode of JAX's parked posteriors gives JAX's
    hypotheses, request by request, through admission waves."""
    js, ts = _servers(topc=topc)
    pending = list(enumerate(feats))
    jfin, tfin = {}, {}
    while pending or js.active.any():
        while pending and js.admit(*pending[0]):
            rid, f = pending.pop(0)
            assert ts.admit(rid, f)
        slots = np.where(js.active)[0]
        ts.logits[slots] = torch.from_numpy(js.logits[slots])
        jd, jocc = js.step()
        td, tocc = ts.step()
        jfin.update(jd)
        tfin.update(td)
        assert tocc == pytest.approx(jocc)
    assert tfin == jfin and len(tfin) == len(feats)
    assert not ts.active.any()


def test_preempt_resume_bit_exact(feats):
    def run(preempt_at):
        _, s = _servers()
        s.admit(0, feats[0])
        s.admit(1, feats[1])
        fin = []
        for i in range(20):
            if i == preempt_at:
                snap = s.preempt(0)
                assert snap["logits"].device.type == "cpu"
                d, _ = s.step()
                fin += d
                assert s.restore(snap)
            d, _ = s.step()
            fin += d
            if not s.active.any():
                break
        return dict(fin)

    base, pre = run(-1), run(1)
    assert base == pre and len(base) == 2


def test_typed_admit_branches(feats):
    _, s = _servers(slots=1)
    r = s.admit(0, np.zeros((20, TINY["input_dim"]), np.float32))
    assert not r and r.reason == PROMPT_TOO_LONG
    r = s.admit(0, np.zeros((0, TINY["input_dim"]), np.float32))
    assert not r and r.reason == NO_BUDGET
    assert s.admit(0, feats[0])
    assert s.admit(1, feats[1]).reason == POOL_FULL
    kinds = [k for k, _, _ in s.events]
    assert kinds == ["reject", "reject", "admit"]
    with pytest.raises(KeyError):
        s.preempt(99)


def test_step_wave_and_reset(feats):
    _, s = _servers()
    assert not s.emits_on_admit
    s.admit(0, feats[0])                              # 11 frames
    s.admit(1, feats[1])                              # 7 frames
    done, progressed, work = s.step_wave()
    assert progressed == [0, 1] and work == 8        # 4 + 4 valid frames
    _, _, work = s.step_wave()
    assert work == 7                                 # 4 + 3 (tail clamp)
    s.reset()
    assert not s.active.any() and not s.events and not s.logits.any()
    assert _drain(s, [(5, feats[2])]).keys() == {5}


def test_dataset_byte_equal_to_jax():
    jcfg, tcfg = _cfgs()
    for var_len, bucket in ((True, False), (True, True), (False, False)):
        kw = dict(seq_len=24, batch=3, seed=4, var_len=var_len,
                  bucket=bucket)
        jd, td = jax_make_dataset(jcfg, **kw), make_dataset(tcfg, **kw)
        for step in (0, 17):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                assert jb[k].tobytes() == tb[k].tobytes(), (k, step)


def test_cli_serves_on_cpu(capsys):
    TS.main(["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
             "--requests", "2", "--slots", "2", "--prompt-len", "12",
             "--max-len", "12", "--beam-width", "2"])
    out = capsys.readouterr().out
    assert "served 2 requests on cpu" in out
