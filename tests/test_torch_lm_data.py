"""The port's synthetic LM, seq2seq and VLM datasets (own copies in
``repro_torch.data.pipeline``) byte-equal to the JAX package's for the
same seed and step; the train CLI (``launch.train.main``) for one arch of
each family at reduced size on the CPU, ``--var-len`` refused for a token
arch; and a checkpoint round trip of a reduced learner-stacked smollm
train state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import make_dataset as jax_make_dataset  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.data import (SyntheticLMDataset,  # noqa: E402
                              SyntheticSeq2SeqDataset, SyntheticVLMDataset,
                              make_dataset)
from repro_torch.launch import train as TT  # noqa: E402


@pytest.mark.parametrize("name,kind", [
    ("smollm-360m", SyntheticLMDataset),
    ("whisper-large-v3", SyntheticSeq2SeqDataset),
    ("internvl2-2b", SyntheticVLMDataset),
])
@pytest.mark.parametrize("reduced", [True, False])
def test_datasets_equal_the_reference(name, kind, reduced):
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    ours = make_dataset(tcfg, seq_len=48, batch=4, seed=3)
    theirs = jax_make_dataset(jcfg, seq_len=48, batch=4, seed=3)
    assert isinstance(ours, kind)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), (name, step, k)


@pytest.mark.parametrize("name", ["smollm-360m", "internvl2-2b"])
def test_var_len_refused_for_token_archs(name):
    cfg = get_arch(name).reduced()
    with pytest.raises(ValueError, match="lstm"):
        make_dataset(cfg, seq_len=16, batch=4, var_len=True)
    with pytest.raises(ValueError, match="lstm"):
        TT.main(["--arch", name, "--reduced", "--device", "cpu", "--steps",
                 "1", "--var-len"])


@pytest.mark.parametrize("name,family,strategy", [
    ("smollm-360m", "dense", "ad_psgd"),
    ("granite-moe-3b-a800m", "moe", "ad_psgd"),
    ("mamba2-370m", "ssm", "ad_psgd"),
    ("hymba-1.5b", "hybrid", "ad_psgd"),
    ("internvl2-2b", "vlm", "ad_psgd"),
    ("whisper-large-v3", "encdec", "sd_psgd"),
])
def test_train_cli_each_family(name, family, strategy, capsys):
    """Two steps of each family's config strategy through the CLI's own
    defaults (128 positions, batch max(8, 2 L)): finite losses, the
    learner-stacked state, and the tokens/s timing line; no stash line
    (lstm only)."""
    cfg = get_arch(name).reduced()
    assert cfg.family == family
    out = TT.main(["--arch", name, "--reduced", "--device", "cpu",
                   "--steps", "2", "--seq-len", "32", "--log-every", "1"])
    text = capsys.readouterr().out
    assert out["meta"]["strategy"].name == strategy
    assert out["meta"]["n_learners"] == cfg.n_learners == 2
    losses = [float(r[3]) for r in out["records"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "tokens/s" in text and "stash:" not in text
    emb = out["state"]["params"]["embed"]
    assert emb.shape == (2, cfg.vocab, cfg.d_model)
    assert out["records"][0][1] == 8 * (16 if family == "encdec" else 24
                                        if family == "vlm" else 32)


def test_checkpoint_round_trip_learner_stacked(tmp_path):
    """A reduced smollm ad_psgd state after one step (params,
    prev_params, the step) saved and restored bit for bit."""
    cfg = get_arch("smollm-360m").reduced()
    state, step, _ = TT.setup_training(cfg, device="cpu")
    batch = make_dataset(cfg, seq_len=16, batch=4).batch_at(0)
    state, _ = step(state, batch)
    save(str(tmp_path), 1, state)
    fresh, _, _ = TT.setup_training(cfg, device="cpu", seed=5)
    back, at = restore(str(tmp_path), fresh)
    assert at == 1 and back["step"] == state["step"] == 1
    for key in ("params", "prev_params"):
        for a, b in zip(TS._leaves(state[key]), TS._leaves(back[key])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    lay = back["params"]["layers"]["attn"]["wq"]
    assert lay.shape[:2] == (2, cfg.n_layers)
