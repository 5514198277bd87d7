"""Training the port's encdec family (``Model.loss_fn`` over 2 learners)
held against the JAX package on the CPU at reduced ``whisper-large-v3``
(1 encoder and 2 decoder layers, d 256, 4 heads of 64, vocab 512), each
learner's weights drawn with numpy on the port's specs and handed to both
packages: the per-learner losses and every gradient leaf at 2e-2 (the
bf16 tolerance of ``test_torch_encdec``), each leaf normalised by the
reference leaf's max-abs.  A batch of 64 positions: 32 stub frames and
32 tokens, the reference's even split.
"""
import pytest

pytest.importorskip("torch")

from test_torch_lm_train import hold_loss_and_grads  # noqa: E402

TOL = 2e-2


def test_loss_and_grads_match_jax():
    hold_loss_and_grads("whisper-large-v3", 64, TOL)


def test_remat_changes_no_gradient():
    """The decoder's per-layer recompute (``cfg.remat``) gives the same
    losses and gradients, bit for bit, as keeping the activations."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as TS
    from repro_torch.models import build_model
    from repro_torch.params import from_jax_params
    from test_torch_lm_train import learner_batch, learner_params

    cfg = get_arch("whisper-large-v3").reduced()
    tp = from_jax_params(learner_params(build_model(cfg), 0))
    batch = {k: torch.as_tensor(v)
             for k, v in learner_batch(cfg, 32, 2).items()}
    outs = [TS._value_and_grad(build_model(dataclasses.replace(
        cfg, remat=remat)).loss_fn, tp, batch) for remat in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(TS._leaves(outs[0][1]), TS._leaves(outs[1][1])):
        assert torch.equal(a, b)
