"""JSON + npz checkpointing of the port's train state (nested dicts,
lists and tuples of tensors and Python scalars) — the port of
``repro.checkpoint.checkpoint``.

Layout:  <dir>/step_<n>/tree.json  (step, leaf key paths, dtypes, shapes)
         <dir>/step_<n>/arrays.npz (tensor payloads, ``leaf_<i>``)

The reference keeps its metadata in msgpack, which the port does not
use; so the two packages' checkpoints are not interchangeable (a JAX
checkpoint has no ``tree.json``, a port checkpoint no
``tree.msgpack``).  The semantics are the reference's:

* **Atomic saves** — payloads go to ``.tmp_step_<n>``, are fsynced
  (files and the directory), then renamed into place, and the parent
  directory is fsynced.  A crash mid-save never leaves a corrupt
  ``step_<n>``: the old state survives or the new one is complete.
  Steps beyond the ``keep`` newest are pruned only after the new one is
  durable.  A save that raises removes its temporary directory.
* **Validated restores** — :func:`restore` checks the saved tree (the
  leaf key paths), every leaf's shape and every leaf's dtype against
  ``state_like`` and raises a :class:`ValueError` naming the leaf path
  (``['params']['layers']...``, the reference's ``keystr``), and
  :class:`FileNotFoundError` when there is no step.
* **Bit-exact round trips** — leaves are stored as raw numpy arrays
  (bf16 viewed as uint16, since npz cannot hold bfloat16); a Python
  scalar leaf (the state's host ``step``) comes back as its own type.
* **Any world size** — a learner-stacked state is saved whole (the train
  CLI's rank 0 gathers every rank's block first, so W ranks write the
  files one process writes), and :func:`restore` with ``learner_block``
  keeps one rank's rows of each stacked leaf (its learners', or its
  hierarchical pods' of a split error-feedback state), and restores the
  leaves every rank holds whole (``whole``: the elastic staleness
  counters, a straddling H-ring's EF state) as saved: a checkpoint
  resumes at any W that divides its learners.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, path=""):
    """(key path, leaf) pairs in a fixed order: dict keys sorted, as
    ``jax.tree.flatten`` orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(tree, it):
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    # a directory fsync makes the names in it durable; not every
    # filesystem lets a directory be opened for it
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(directory: str, step: int, state, *, keep: int = 3) -> str:
    """Atomically persist ``state`` as ``<directory>/step_<step>``.

    Write order: temp dir -> payload files -> fsync the files -> fsync
    the temp dir -> rename -> fsync the parent -> prune, so no incomplete
    ``step_<n>`` ever exists under its final name."""
    os.makedirs(directory, exist_ok=True)
    leaves = list(_flatten(state))
    arrays = {f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(leaves)}
    meta = {
        "step": int(step),
        "n_leaves": len(leaves),
        "paths": [p for p, _ in leaves],
        "dtypes": [_dtype_name(x) for _, x in leaves],
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        tree_path = os.path.join(tmp, "tree.json")
        with open(tree_path, "w", encoding="utf-8") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path, **arrays)
        _fsync_file(arrays_path)
        _fsync_dir(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)

    # the new step is durable: only now retire the oldest beyond `keep`
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
    return final


def latest_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return [int(d.split("_", 1)[1]) for d in os.listdir(directory)
            if d.startswith("step_")]


def latest_step(directory: str):
    steps = latest_steps(directory)
    return max(steps) if steps else None


def _from_numpy(a: np.ndarray, dtype: str, ref):
    if not isinstance(ref, torch.Tensor):
        return type(ref)(a.item())
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(ref.device)


def _under(path: str, keys) -> bool:
    """Whether the leaf path lies under one of the top-level ``keys``."""
    return any(path.startswith(f"[{k!r}]") for k in keys)


def restore(directory: str, state_like, step: int = None, *,
            learner_block: tuple = None, whole=()):
    """Restore into the structure of ``state_like``; returns (state,
    step).  Tensors land on the device of their ``state_like`` leaf.

    The saved leaf paths and every leaf's shape and dtype are checked
    against ``state_like``; a mismatch raises a ValueError naming the
    leaf path, the expected and the found shape or dtype, so a
    checkpoint of another strategy, config or learner count fails loudly
    instead of restoring into the wrong slot.  ``learner_block`` (start,
    count, total): ``state_like`` is one rank's block of a learner-stacked
    state of ``total`` learners, saved whole, W = total / count ranks
    holding ``count`` each; a tensor leaf of n rows here was saved with
    n·W (its learners, or the pods of a split EF state), of which rows
    [r·n, (r+1)·n) are restored, r = start / count.  The leaves under a
    top-level key in ``whole`` are held whole by every rank and restored
    as saved."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "tree.json"), encoding="utf-8") as f:
        meta = json.load(f)
    expected = list(_flatten(state_like))
    paths = [p for p, _ in expected]
    if meta["paths"] != paths:
        extra = sorted(set(meta["paths"]) - set(paths))
        missing = sorted(set(paths) - set(meta["paths"]))
        raise ValueError(
            f"checkpoint {path} tree structure mismatch: saved but not "
            f"expected {extra[:4]}, expected but not saved {missing[:4]} "
            f"(different strategy/optimizer than the saved run? state "
            f"keys like 'prev_params'/'anchor' are strategy-dependent)")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, ref) in enumerate(expected):
            a = data[f"leaf_{i}"]
            dt = meta["dtypes"][i]
            expect_shape = tuple(np.shape(ref))
            if learner_block is not None and isinstance(ref, torch.Tensor) \
                    and ref.dim() > 0 and not _under(name, whole):
                start, count, total = learner_block
                W, n = total // count, expect_shape[0]
                expect_shape = (n * W,) + expect_shape[1:]
                if tuple(a.shape) == expect_shape:
                    r = start // count
                    a = a[r * n:(r + 1) * n]
                    expect_shape = tuple(np.shape(ref))
            if tuple(a.shape) != expect_shape:
                raise ValueError(
                    f"checkpoint {path} leaf {name!r}: saved shape "
                    f"{tuple(a.shape)} != expected {expect_shape} "
                    f"(learner count or architecture changed since the "
                    f"save?)")
            expect_dtype = _dtype_name(ref)
            if dt != expect_dtype:
                raise ValueError(
                    f"checkpoint {path} leaf {name!r}: saved dtype {dt} "
                    f"!= expected {expect_dtype}")
            out.append(_from_numpy(a, dt, ref))
    return _unflatten(state_like, iter(out)), step
