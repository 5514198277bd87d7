"""The port's recognition scoring (``repro_torch.launch.evaluate``, its
own copies of ``eval/metrics.py`` and the CSV helpers) held against the
JAX package on the CPU.

Tolerances:

* the copies of ``eval/metrics.py`` and of the ``name,value,derived``
  helpers are byte-equal to the originals;
* the forward's logits on the same params and held-out batches: 2e-2 of
  JAX's ``kernel_impl="pallas"`` path after normalising by its max-abs
  (bf16 forward, docs/kernels.md §Oracle tolerances);
* given JAX's logits, the metrics and the max-semiring beam decode are
  exact: FER, both TERs and every hypothesis equal JAX's, and the
  hypotheses equal the numpy oracle ``prefix_beam_ref`` (vocab 512);
* the chunked decode equals the one-shot decode exactly.
"""
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro.decode import ref as jdref  # noqa: E402
from repro.launch import evaluate as JE  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.sharding import init_spec_tree  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import evaluate as TE  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BF16_TOL = 2e-2
EVAL = dict(batches=2, batch=4, seq_len=12, var_len=True, seed=3)


def test_metrics_copy_is_byte_equal():
    mine = (ROOT / "src/repro_torch/eval/metrics.py").read_bytes()
    assert mine == (ROOT / "src/repro/eval/metrics.py").read_bytes()


def test_csv_helpers_are_the_originals(capsys):
    assert tobs.CSV_HEADER == jobs.CSV_HEADER
    for name in ("csv_row", "print_csv_rows"):
        assert inspect.getsource(getattr(tobs, name)) == \
            inspect.getsource(getattr(jobs, name))
    rows = [("a/b", 0.123456789, "x"), ("c", "n/a", ""), ("d", 3, "y, z")]
    jobs.print_csv_rows(rows, header=True)
    want = capsys.readouterr().out
    tobs.print_csv_rows(rows, header=True)
    assert capsys.readouterr().out == want


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_arch("swb2000-blstm").reduced()
    tcfg = get_arch("swb2000-blstm").reduced()
    params = init_spec_tree(jlstm.param_specs(jcfg), jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params))
    return jcfg, tcfg, params, tparams


def _recorded(monkeypatch):
    """Record what evaluate's forward and decode return, batch by batch
    (the first call is the warm-up on batch 0)."""
    rec = {"logits": [], "hyps": []}
    forward, finalize = TE.LS.forward, TE.DC.finalize

    def rec_forward(cfg, p, feats, lengths=None, **kw):
        out = forward(cfg, p, feats, lengths, **kw)
        rec["logits"].append((lengths, out))
        return out

    def rec_finalize(st, **kw):
        toks, lens, scores = finalize(st, **kw)
        rec["hyps"].append([r[:n].tolist() for r, n in zip(toks, lens)])
        return toks, lens, scores
    monkeypatch.setattr(TE.LS, "forward", rec_forward)
    monkeypatch.setattr(TE.DC, "finalize", rec_finalize)
    return rec


def _heldout(jcfg):
    ds = jax_make_dataset(jcfg, seq_len=EVAL["seq_len"], batch=EVAL["batch"],
                          seed=EVAL["seed"], var_len=True)
    return [ds.batch_at(TE.HELDOUT_OFFSET + i)
            for i in range(EVAL["batches"])]


def test_evaluate_logits_match_jax_pallas(model, monkeypatch):
    jcfg, tcfg, params, tparams = model
    assert TE.HELDOUT_OFFSET == JE.HELDOUT_OFFSET
    rec = _recorded(monkeypatch)
    TE.evaluate_params(tcfg, tparams, device="cpu", **EVAL)
    for b, (lengths, logits) in zip(_heldout(jcfg), rec["logits"][1:]):
        assert np.array_equal(lengths.numpy(), b["lengths"])
        want = np.asarray(jlstm.forward(
            jcfg, params, jnp.asarray(b["features"]),
            jnp.asarray(b["lengths"]), kernel_impl="pallas"), np.float32)
        got = logits.numpy()
        assert got.shape == want.shape
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert err <= BF16_TOL, err


def test_metrics_and_decode_equal_jax_on_jax_logits(model, monkeypatch):
    """The port's scoring path fed JAX's logits (its forward replaced)
    returns JAX's FER and TERs exactly, and JAX's beam hypotheses."""
    jcfg, tcfg, params, tparams = model
    beam = 4
    want = JE.evaluate_params(jcfg, params, kernel_impl="pallas", beam=beam,
                              **EVAL)
    batches = _heldout(jcfg)
    logits = {b["features"].tobytes(): np.asarray(jlstm.forward(
        jcfg, params, jnp.asarray(b["features"]),
        jnp.asarray(b["lengths"]), kernel_impl="pallas"), np.float32)
        for b in batches}

    def jax_forward(cfg, p, feats, lengths=None, **kw):
        return torch.from_numpy(logits[feats.numpy().tobytes()].copy())
    monkeypatch.setattr(TE.LS, "forward", jax_forward)
    rec = _recorded(monkeypatch)
    got = TE.evaluate_params(tcfg, tparams, device="cpu", beam=beam, **EVAL)
    for key in ("fer", "ter_greedy", "ter_beam", "valid_frames",
                "beam_occupancy"):
        assert got[key] == want[key], key
    from repro import decode as JD
    for b, hyps in zip(batches, rec["hyps"][1:]):
        lg = logits[b["features"].tobytes()]
        toks, lens, _ = JD.beam_search(jnp.asarray(lg),
                                       jnp.asarray(b["lengths"]), beam=beam,
                                       impl="pallas")
        jhyps = [list(map(int, r[:n])) for r, n in
                 zip(np.asarray(toks), np.asarray(lens))]
        assert hyps == jhyps
        ref, _ = jdref.prefix_beam_ref(lg, b["lengths"], beam=beam)
        assert hyps == ref
    assert tcfg.vocab == 512
    assert sum(len(h) for hyps in rec["hyps"] for h in hyps) > 0


def test_chunked_decode_equals_one_shot(model, monkeypatch):
    _, tcfg, _, tparams = model
    rec = _recorded(monkeypatch)
    one = TE.evaluate_params(tcfg, tparams, device="cpu", **EVAL)
    chunked = TE.evaluate_params(tcfg, tparams, device="cpu", decode_chunk=5,
                                 **EVAL)
    n = EVAL["batches"] + 1
    assert rec["hyps"][:n] == rec["hyps"][n:]
    assert sum(map(len, sum(rec["hyps"], []))) > 0
    for key in ("fer", "ter_greedy", "ter_beam", "beam_occupancy"):
        assert one[key] == chunked[key], key


def test_train_then_evaluate_cli(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    TT.main(["--reduced", "--device", "cpu", "--steps", "2", "--log-every",
             "0", "--ckpt-dir", ck, "--ckpt-every", "2"])
    capsys.readouterr()
    TE.main(["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
             "--ckpt-dir", ck, "--batches", "1", "--var-len",
             "--decode-chunk", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "restored ad_psgd checkpoint at step 2 (L=2, " \
                     "consensus params)"
    assert out[1] == "name,value,derived"
    names = [line.split(",")[0] for line in out[2:]]
    assert names == ["evaluate/ad_psgd/" + n for n in (
        "fer", "ter_greedy", "ter_beam8", "frames_per_s",
        "decoded_tok_per_s", "beam_occupancy")]
    with pytest.raises(ValueError, match=r"leaf .*saved shape \(2, "):
        TE.main(["--arch", "swb2000-blstm", "--reduced", "--device", "cpu",
                 "--ckpt-dir", ck, "--learners", "3"])
    with pytest.raises(SystemExit, match="acoustic"):
        TE.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                 "--ckpt-dir", ck])
    with pytest.raises(SystemExit, match="--resume: no checkpoint"):
        TT.main(["--reduced", "--device", "cpu", "--steps", "1", "--resume",
                 "--ckpt-dir", str(tmp_path / "empty")])
