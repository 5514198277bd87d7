#!/usr/bin/env python3
"""How far LM training gradients move under rounding alone, on the CPU:
the measurements behind the gradient tolerances of the training parity
tests (``tests/test_torch_{lm,ssm,encdec}_train.py``) and of
``chip_smoke.py``'s lm-train kernel-vs-plain checks.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/grad_sensitivity.py

Each line gives, over every gradient leaf, the worst leaf's error
normalised by the reference leaf's max-abs ("max") and its relative L2
distance ("l2"):

1. moe — the port's ``Model.loss_fn`` against the JAX package's vmapped
   value_and_grad for reduced granite-moe-3b-a800m and llama4-scout over
   four seeds (routing flips move whole experts);
2. ssm — reduced mamba2-370m and hymba-1.5b: the reference against itself
   with its SSD's bf16 casts lifted to f32 (a local twin of
   ``repro.models.ssm.ssd_chunked``), and the port against both;
3. attention — whisper-large-v3 and internvl2-2b at full width cut to 4
   layers (4 encoder layers for whisper): the port's CPU path, whose
   attention rounds p to bf16 before p·v as the reference's does,
   against the same with the all-f32 ``flash_attention_plain``.

Imports the JAX package: a CPU analysis tool, not part of the port.
"""
import dataclasses
import os
import sys
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"),
                os.path.join(HERE, "..", "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.models.ssm as JSM  # noqa: E402
import test_torch_lm_train as T  # noqa: E402
from repro_torch.core import strategies as ST  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.params import init_params  # noqa: E402


def worst(jgrads, tgrads):
    """(max-abs normalised, relative L2) of the worst leaf each, with its
    path; a key bias ``bk`` (a zero gradient in exact arithmetic) is
    left out."""
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    out = {"max": (0.0, ""), "l2": (0.0, "")}
    for path, want in jax.tree_util.tree_flatten_with_path(ref)[0]:
        name = jax.tree_util.keystr(path)
        if name.endswith("['bk']"):
            continue
        got = T._at(tgrads, path).float().numpy()
        d = got - want
        errs = {"max": np.abs(d).max() / (np.abs(want).max() + 1e-30),
                "l2": np.linalg.norm(d) / (np.linalg.norm(want) + 1e-30)}
        for k, e in errs.items():
            if e > out[k][0]:
                out[k] = (float(e), name)
    return out


def show(tag, w):
    print(f"{tag}: max {w['max'][0]:.4f} {w['max'][1]}, l2 "
          f"{w['l2'][0]:.4f} {w['l2'][1]}", flush=True)


def jax_grads(jm, npp, batch):
    return jax.jit(jax.vmap(jax.value_and_grad(jm.loss_fn)))(
        jax.tree.map(jnp.asarray, npp),
        {k: jnp.asarray(v) for k, v in batch.items()})[1]


def port_grads(tm, npp, batch):
    return ST._value_and_grad(
        tm.loss_fn, T.from_jax_params(npp),
        {k: torch.as_tensor(v) for k, v in batch.items()})[1]


def ssd_f32(x, dt, A_, Bm, Cm, chunk, h0=None):
    """``repro.models.ssm.ssd_chunked`` with every bf16 cast lifted: the
    same chunked algorithm all in f32, y cast to x's dtype once."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0, pad = S, (-S) % Q
    x, dt, Bm, Cm = (a.astype(jnp.float32) for a in (x, dt, Bm, Cm))
    if pad:
        def zp(a):
            return jnp.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
        x, dt, Bm, Cm = zp(x), zp(dt), zp(Bm), zp(Cm)
        S += pad
    nc = S // Q

    def chunks(a):
        return jnp.moveaxis(a.reshape(B, nc, Q, *a.shape[2:]), 1, 0)

    def body(h, inp):
        x_, dt_, B_, C_ = inp
        cum = jnp.cumsum(dt_ * A_, axis=1)
        scores = jnp.einsum("bqhn,bkhn->bhqk", C_, B_)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        mask = jnp.tril(jnp.ones((Q, Q), bool))
        decay = jnp.exp(jnp.where(mask[None, :, :, None], diff, -1e30))
        w = scores * jnp.moveaxis(decay, 3, 1)
        y = jnp.einsum("bhqk,bkh,bkhp->bqhp", w, dt_, x_)
        y = y + jnp.einsum("bqhn,bhnp,bqh->bqhp", C_, h, jnp.exp(cum))
        last = cum[:, -1:, :]
        s_c = jnp.einsum("bkhn,bkh,bkhp->bhnp", B_,
                         jnp.exp(last - cum) * dt_, x_)
        return jnp.exp(last[:, 0, :])[:, :, None, None] * h + s_c, y

    h, ys = jax.lax.scan(body, jnp.zeros((B, H, N, P), jnp.float32),
                         tuple(map(chunks, (x, dt, Bm, Cm))))
    y = jnp.moveaxis(ys, 0, 1).reshape(B, S, H, P)[:, :S0]
    return y.astype(jnp.bfloat16), h


def moe_seeds():
    for name, S in (("granite-moe-3b-a800m", 32),
                    ("llama4-scout-17b-a16e", 80)):
        jm = T.jax_build_model(T.jax_get_arch(name).reduced())
        tm = T.build_model(T.get_arch(name).reduced())
        for seed in range(4):
            npp = T.learner_params(tm, seed, router_sharp=True)
            batch = T.learner_batch(tm.cfg, S, 2, seed)
            show(f"moe {name} seed {seed}: port vs reference",
                 worst(jax_grads(jm, npp, batch),
                       port_grads(tm, npp, batch)))


def ssm_twin():
    real = JSM.ssd_chunked
    for name in ("mamba2-370m", "hymba-1.5b"):
        jm = T.jax_build_model(T.jax_get_arch(name).reduced())
        tm = T.build_model(T.get_arch(name).reduced())
        for seed in (0, 1):
            npp = T.learner_params(tm, seed)
            batch = T.learner_batch(tm.cfg, 80, 2, seed)
            ref = jax_grads(jm, npp, batch)
            with mock.patch.object(JSM, "ssd_chunked", ssd_f32):
                twin = jax_grads(jm, npp, batch)
            assert JSM.ssd_chunked is real
            port = port_grads(tm, npp, batch)
            tag = f"ssm {name} seed {seed}"
            show(f"{tag}: reference vs its f32-SSD twin", worst(
                ref, T.from_jax_params(jax.tree.map(np.asarray, twin))))
            show(f"{tag}: port vs reference", worst(ref, port))
            show(f"{tag}: port vs the f32-SSD twin", worst(twin, port))


def attention_p_rounding():
    def f32_attn(q, k, v, causal, window=None, **_):
        return flash_attention_plain(
            q, k, v, causal=causal, window=0 if window is None
            else int(window))

    for name, extra in (("whisper-large-v3", dict(n_enc_layers=4)),
                        ("internvl2-2b", {})):
        cfg = dataclasses.replace(T.get_arch(name), n_layers=4, vocab=4096,
                                  **extra)
        tm = T.build_model(cfg)
        params = ST.stack_for_learners(
            init_params(tm.param_specs(), 0, "cpu"), 2)
        b = make_dataset(cfg, seq_len=128, batch=4, seed=0).batch_at(2)
        batch = {k: torch.as_tensor(v).reshape(2, 2, *v.shape[1:])
                 for k, v in b.items()}
        bf16_p = ST._value_and_grad(tm.loss_fn, params, batch)[1]
        with mock.patch.object(A, "attn_seq", f32_attn):
            f32_p = ST._value_and_grad(tm.loss_fn, params, batch)[1]
        as_ref = jax.tree.map(lambda t: t.float().numpy(), f32_p)
        show(f"attention {name} (full width, 4 layers): bf16 p vs f32 p",
             worst(as_ref, bf16_p))


if __name__ == "__main__":
    moe_seeds()
    ssm_twin()
    attention_p_rounding()
