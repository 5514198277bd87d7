"""Dry-run: what an (architecture x shape) step needs, without running it
— the port of ``repro.launch.dryrun`` for one H100.

``--mesh local`` (the default, the one card): trace the real step on fake
tensors (``FakeTensorMode``: shapes and dtypes, no data, no allocation)
and count it (``analysis/counts.py``).  Every kernel wrapper takes its
plain version on a fake tensor (``repro_torch.device.plain_path``), so
the trace is the plain path, as the reference's dry-run lowers its jnp
path, and not the kernel path the card runs: its peak, cost and ``fits``
hold, for example, the (S, S) attention scores that K11 never
materialises.  Each record says so (``"path": "plain"``).

* ``train``: ``launch/train.setup_training``'s state (params, optimizer
  state, ``prev_params`` for a stale strategy, the wire's comm state) and
  the arch's strategy step over the shape's global batch split across
  ``cfg.n_learners`` (``repro/launch/dryrun.py:55-102``);
* ``prefill`` / ``decode``: ``Model.prefill_fn`` and ``Model.decode_fn``
  over ``Model.cache_specs(shape)`` (``long_500k`` with the arch's long-
  context window).

Each record (``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``)
holds ``memory`` (``argument_gb``: params, state and batch; ``output_gb``;
``temp_gb``: the peak of live storages less the arguments), ``cost``
(flops, bytes), the op ``counts``, the H100 ``roofline`` at one chip,
``params_total``, ``params_active_nonembed``, ``model_flops`` and its
ratio to the counted flops, and ``fits``: the plain path's peak against
the card's 80 GB.  Fake CUDA tensors need no card, but autograd on them needs a CUDA
build of PyTorch: a train shape on ``--device cuda`` raises without one
(pass ``--device cpu``).

``--mesh pod|multipod`` traces nothing: it records the per-device bytes
of params, state and batch under the reference's sharding rules on the
(16, 16) or (2, 16, 16) geometry (``sharding.MeshRules.local_shape``),
with chips = 256 or 512, the parameter counts and ``model_flops``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape decode_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \\
      --shape train_4k --mesh pod --opt
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.counts import count_with_output
from repro_torch.analysis.params import count_active_params, count_params
from repro_torch.analysis.roofline import HW, model_flops, roofline_terms
from repro_torch.configs import ASSIGNED_ARCHS, get_arch, get_shape
from repro_torch.core import strategies as ST
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import build_model
from repro_torch.optim.optimizers import sgd
from repro_torch.sharding import spec_tree_bytes, spec_tree_to_fake

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"local": "local_1xh100", "pod": "pod_16x16",
          "multipod": "multipod_2x16x16"}


def _train_parts(cfg, shape, *, multi_pod: bool = False):
    """(strategy, n_learners, transport, learner lead, batch specs split
    over the learners) of a train shape, as the reference builds them."""
    model = build_model(cfg)
    if multi_pod:
        strategy, n_learners = ST.get_strategy("hring"), 2
    else:
        strategy = ST.get_strategy(cfg.train_strategy)
        n_learners = cfg.n_learners if strategy.replicated else 1
    transport = ST.transport_from_cfg(cfg, strategy)
    lead = ((n_learners, "learner"),) if strategy.replicated else ()
    inputs = model.input_specs(shape, "train")
    if strategy.replicated:
        def split(ps):
            B = ps.shape[0]
            if B % n_learners:
                raise ValueError(f"global batch {B} does not split over "
                                 f"{n_learners} learners")
            return ps._replace(
                shape=(n_learners, B // n_learners) + tuple(ps.shape[1:]),
                axes=("learner",) + tuple(ps.axes))
        inputs = {k: split(v) for k, v in inputs.items()}
    return model, strategy, n_learners, transport, lead, inputs


def build_train(cfg, shape, device):
    """(step, args, meta) of the arch's strategy step, all fake."""
    model, strategy, n_learners, transport, lead, inputs = _train_parts(
        cfg, shape)
    if torch.device(device).type == "cuda" and \
            not torch.backends.cuda.is_built():
        raise ValueError("a train dry-run on fake CUDA tensors runs autograd "
                         "on them, which needs a CUDA build of PyTorch; pass "
                         "--device cpu")
    opt = sgd()
    step = ST.make_train_step(
        strategy, model.loss_fn, opt, lambda s: 0.1, n_learners=n_learners,
        microbatches=cfg.microbatches, pre_split=strategy.replicated,
        transport=transport)
    params = spec_tree_to_fake(model.param_specs(), lead, device=device)
    state = ST.init_state(strategy, params, opt, transport=transport)
    batch = spec_tree_to_fake(inputs, device=device)
    return step, (state, batch), {"strategy": strategy.name,
                                  "n_learners": n_learners}


def build_prefill(cfg, shape, device):
    model = build_model(cfg)
    long_ctx = shape.name == "long_500k"
    fn = functools.partial(model.prefill_fn, cache_len=shape.seq_len,
                           long_context=long_ctx)
    params = spec_tree_to_fake(model.param_specs(), device=device)
    batch = spec_tree_to_fake(model.input_specs(shape, "prefill"),
                              device=device)
    return fn, (params, batch), {"strategy": "serve"}


def build_decode(cfg, shape, device):
    model = build_model(cfg)
    long_ctx = shape.name == "long_500k"
    params = spec_tree_to_fake(model.param_specs(), device=device)
    cache = spec_tree_to_fake(model.cache_specs(shape), device=device)
    tokens = spec_tree_to_fake(model.input_specs(shape, "decode")["tokens"],
                               device=device)
    # the position of the new token (the cache's last), a host int in the
    # port's decode; an encdec self cache holds half the sequence
    last = (shape.seq_len // 2 if cfg.family == "encdec"
            else shape.seq_len) - 1
    fn = functools.partial(model.decode_fn, pos=last, long_context=long_ctx)
    return (lambda p, c, t: fn(p, c, t)), (params, cache, tokens), \
        {"strategy": "serve"}


def _unique_bytes(tree) -> int:
    """The bytes of the distinct storages under a tree's tensors."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _params_record(rec, cfg, shape, specs_model):
    specs = specs_model.param_specs()
    n_active = count_active_params(cfg, specs)
    rec["params_total"] = count_params(specs)
    rec["params_active_nonembed"] = n_active
    rec["model_flops"] = model_flops(cfg, shape, n_active, shape.kind)
    return rec


def _run_local(rec, cfg, shape, device):
    make = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}[shape.kind]
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, meta = make(cfg, shape, device)
    rec.update(meta)
    arg_bytes = _unique_bytes(args)
    stats, out = count_with_output(fn, *args)
    rec["trace_s"] = round(time.time() - t0, 2)
    out_bytes = _unique_bytes(out)
    rec["memory"] = {"argument_gb": arg_bytes / 1e9,
                     "output_gb": out_bytes / 1e9,
                     "temp_gb": (stats.peak_bytes - arg_bytes) / 1e9,
                     "peak_gb": stats.peak_bytes / 1e9}
    rec["argument_bytes"] = arg_bytes
    rec["peak_bytes"] = stats.peak_bytes
    rec["cost"] = {"flops": stats.flops, "bytes": stats.bytes}
    rec["counts"] = stats.to_json()
    rec["chips"] = 1
    rec["roofline"] = roofline_terms(
        {"flops": stats.flops, "bytes": stats.bytes,
         "collective_bytes": stats.collective_bytes}, chips=1)
    rec["hardware"] = {"name": HW.name, "power_limit_w": HW.power_limit_w,
                       "hbm_bytes": HW.hbm_per_chip}
    _params_record(rec, cfg, shape, build_model(cfg))
    rec["model_flops_ratio"] = (rec["model_flops"] / stats.flops
                                if stats.flops else 0.0)
    rec["fits"] = stats.peak_bytes <= HW.hbm_per_chip
    rec["path"] = "plain"         # the kernels' plain versions, traced
    return rec


def _run_mesh(rec, cfg, shape, multi_pod: bool):
    """Per-device argument bytes of params, state and batch on a
    production geometry (no trace)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_for(cfg, mesh, multi_pod=multi_pod)
    model = build_model(cfg)
    specs = model.param_specs()
    if shape.kind == "train":
        _, strategy, n_learners, transport, lead, inputs = _train_parts(
            cfg, shape, multi_pod=multi_pod)
        params = spec_tree_bytes(specs, rules, lead)
        state = params if strategy.stale else 0     # prev_params
        if strategy.replicated and transport.needs_state:
            # the error-feedback residual and estimate, f32
            state += 2 * spec_tree_bytes(_f32_specs(specs), rules, lead)
        rec.update(strategy=strategy.name, n_learners=n_learners)
    else:
        params = spec_tree_bytes(specs, rules)
        state = (spec_tree_bytes(model.cache_specs(shape), rules)
                 if shape.kind == "decode" else 0)
        inputs = model.input_specs(shape, shape.kind)
        rec["strategy"] = "serve"
    batch = spec_tree_bytes(inputs, rules)
    per_dev = params + state + batch
    rec["memory"] = {"argument_gb": per_dev / 1e9,
                     "params_gb": params / 1e9, "state_gb": state / 1e9,
                     "batch_gb": batch / 1e9}
    rec["chips"] = mesh.size
    rec["fits_hbm_80gb"] = per_dev <= HW.hbm_per_chip
    _params_record(rec, cfg, shape, model)
    return rec


def _f32_specs(tree):
    if isinstance(tree, dict):
        return {k: _f32_specs(v) for k, v in tree.items()}
    return tree._replace(dtype="float32")


def run_one(arch: str, shape_name: str, *, mesh: str = "local",
            device="cuda", opt: bool = False, cfg_override=None,
            shape=None) -> dict:
    """One dry-run record.  ``shape`` (a ShapeConfig) overrides the
    registry's ``shape_name`` and ``cfg_override`` the arch's config (the
    tests run reduced configs at small shapes)."""
    cfg = cfg_override or get_arch(arch)
    if opt and cfg_override is None:
        cfg = cfg.optimized()
    shape = shape or get_shape(shape_name)
    mesh_name = MESHES[mesh] + ("_opt" if opt else "")
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "variant": "optimized" if opt else "baseline",
           "status": "skipped"}
    if not cfg.supports_shape(shape.name):
        rec["reason"] = f"{arch} skips {shape.name} (skip_shapes)"
        return rec
    if shape.is_decode and not cfg.supports_decode:
        rec["reason"] = "no decode step for this family"
        return rec
    if mesh == "local":
        _run_local(rec, cfg, shape, device)
    else:
        _run_mesh(rec, cfg, shape, multi_pod=mesh == "multipod")
    rec["status"] = "ok"
    return rec


def _line(tag, rec) -> str:
    if rec["status"] != "ok":
        return (f"{tag:60s} {rec['status']}: "
                f"{rec.get('reason', rec.get('error', ''))[:110]}")
    m = rec["memory"]
    if "roofline" in rec:
        r = rec["roofline"]
        return (f"{tag:60s} ok  trace {rec['trace_s']:7.1f}s args "
                f"{m['argument_gb']:8.3f} GB peak {m['peak_gb']:8.3f} GB "
                f"fits={rec['fits']} (plain path) dom={r['dominant']} "
                f"bound={r['bound_s']:.3e}s")
    return (f"{tag:60s} ok  per-device args {m['argument_gb']:8.3f} GB "
            f"on {rec['chips']} chips")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="local", choices=sorted(MESHES))
    ap.add_argument("--opt", action="store_true",
                    help="the §Perf overlay (ArchConfig.optimized())")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors sit (local mesh): cuda "
                         "(no card needed for prefill and decode) or cpu")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = (f"{arch}__{shape}__{MESHES[args.mesh]}"
                   f"{'_opt' if args.opt else ''}")
            try:
                rec = run_one(arch, shape, mesh=args.mesh,
                              device=args.device, opt=args.opt)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": MESHES[args.mesh], "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(_line(tag, rec), flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
