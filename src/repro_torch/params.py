"""Parameter trees: specs, seeded init, and weights carried over from JAX.

Parameters are plain nested dicts of tensors under the reference's tree
keys — the BLSTM's ``layers/layer_i/{fwd,bwd}/{wx,wh,b}``,
``bottleneck``, ``softmax_w``, ``softmax_b``; the transformer's
layer-stacked ``layers/{ln1,attn,ln2,mlp}/...``, for the moe family
``layers/{ln1,attn,ln2,moe}/...``, for the ssm family
``layers/{ln1,ssm}/...`` (leading axis L),
``embed`` and ``final_norm`` (the vlm family's are the dense family's);
the encdec family's ``embed``, ``enc_layers/{ln1,attn,ln2,mlp}/...``,
``enc_norm``, ``dec_layers/{ln1,self_attn,lnx,cross_attn,ln2,mlp}/...``
and ``dec_norm`` — so a JAX parameter tree converted to
numpy loads one-to-one through :func:`from_jax_params`, and a JAX train
state through :func:`from_jax_state`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ParamSpec(NamedTuple):
    """Shape + dtype + init recipe + logical axes of one parameter (the
    fields of ``repro.sharding.ParamSpec``; ``axes`` comes last so that a
    positional spec keeps its meaning).  ``axes`` names each dimension's
    logical axis ('embed', 'heads', 'experts', ..., or None), which the
    sharding rules (``repro_torch.sharding``) and the active-parameter
    count (``repro_torch.analysis.params``) read; () where no rule reads
    it."""

    shape: tuple
    dtype: str = "bfloat16"
    init: str = "normal"          # normal | zeros | ones | lecun | small_a_log
    init_scale: float = 0.02
    axes: tuple = ()


# a leaf is drawn in f32 and cast, so drawing it whole takes an f32 copy
# beside its own bytes; a leaf of more elements than this (8 GiB of f32)
# is drawn one slice of its first axis at a time, which lets command-r-
# 35b's 60.57 GB of bf16 weights be drawn on one 80 GB card
DRAW_WHOLE_MAX = 2 ** 31


def _init_one(ps: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    """``sharding.init_param`` semantics: draws in f32 on the generator's
    device, then casts (a leaf past ``DRAW_WHOLE_MAX`` elements a slice of
    its first axis at a time)."""
    dtype, dev = _DTYPES[ps.dtype], gen.device
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=dev)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=dev)
    if ps.init == "small_a_log":
        # mamba2 A_log: the log of A drawn uniformly from [1, 16)
        u = torch.rand(ps.shape, generator=gen, dtype=torch.float32,
                       device=dev)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if ps.init == "lecun":
        fan_in = ps.shape[0] if len(ps.shape) >= 1 else 1
        scale = 1.0 / np.sqrt(max(fan_in, 1))
    elif ps.init == "normal":
        scale = ps.init_scale
    else:
        raise ValueError(f"unknown init {ps.init!r}")

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(scale).to(dtype)

    if len(ps.shape) < 2 or np.prod(ps.shape, dtype=np.int64) <= \
            DRAW_WHOLE_MAX:
        return draw(ps.shape)
    out = torch.empty(ps.shape, dtype=dtype, device=dev)
    for i in range(ps.shape[0]):
        out[i] = draw(ps.shape[1:])
    return out


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def init_params(spec_tree, seed: int, device) -> dict:
    """Materialise a spec tree on ``device`` from one ``torch.Generator``
    there, seeded with ``seed`` (leaves drawn in sorted-key order): a
    model's billions of weights are drawn on the card, not the host.  The
    same seed gives other numbers on the CPU and on the card, and other
    numbers than ``jax.random``; carry weights over with
    :func:`from_jax_params` (or ``.to``) where they must agree."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return _map_tree(lambda ps: _init_one(ps, gen), spec_tree)


def param_bytes(spec_tree) -> int:
    """The bytes a spec tree's tensors take, from shapes and dtypes."""
    if isinstance(spec_tree, dict):
        return sum(param_bytes(v) for v in spec_tree.values())
    n = int(np.prod(spec_tree.shape, dtype=np.int64))
    return n * _DTYPES[spec_tree.dtype].itemsize


def zeros_from_specs(spec_tree, device) -> dict:
    """Zero tensors of a spec tree on ``device`` (decode-state buffers)."""
    return _map_tree(lambda ps: torch.zeros(ps.shape, dtype=_DTYPES[ps.dtype],
                                            device=device), spec_tree)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(tree, device="cpu") -> dict:
    """A JAX parameter tree whose leaves were converted to numpy
    (``jax.tree.map(np.asarray, params)``) -> the port's parameter dict,
    same keys, same dtypes (bf16 bits carried exactly), on ``device``."""
    return _map_tree(lambda a: _to_tensor(a).to(device), tree)


def _state_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _state_tree(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_state_tree(v, device) for v in tree)
    return _to_tensor(tree).to(device)


def from_jax_state(state, device="cpu") -> dict:
    """A JAX train state whose leaves were converted to numpy
    (``jax.tree.map(np.asarray, state)`` of ``repro.core.strategies.
    init_state`` or ``init_elastic_state``) -> the port's state:
    ``params``, ``prev_params``, ``anchor``, ``block_mom``, ``opt`` and
    ``comm`` (the error-feedback residual and estimate, f32) as tensors on
    ``device`` (bf16 bits carried exactly, an empty optimizer state kept
    as ``()``), ``step`` as a host int, and the elastic state's
    ``staleness`` counters as an int32 tensor on the host, where the
    port's elastic step keeps them
    (``repro_torch.core.strategies.init_elastic_state``)."""
    out = {}
    for key, value in state.items():
        if key == "step":
            out[key] = int(np.asarray(value))
        elif key == "staleness":
            out[key] = torch.from_numpy(
                np.array(value, dtype=np.int32, copy=True))
        elif key in ("params", "prev_params", "anchor", "block_mom", "opt",
                     "comm"):
            out[key] = _state_tree(value, device)
        else:
            raise ValueError(f"state key {key!r} has no counterpart in the "
                             f"port")
    return out
