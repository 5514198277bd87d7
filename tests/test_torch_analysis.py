"""The port's analysis modules and its dry-run, on the CPU.

* ``analysis/roofline``: the H100's ``Hardware`` and the reference's
  formulas for ``model_flops`` and ``roofline_terms``.
* ``analysis/counts.count``: the FLOPs of a reduced dense prefill (and of
  a reduced moe and ssm prefill) equal the reference's HLO count
  (``analyze_hlo`` of the compiled ``jax.jit``) within 1 %; a miss names
  the op kinds the port counted.  Its bytes and peak on a step whose
  answer is known by hand.
* ``launch/dryrun.run_one``: one record per family at a small
  ``ShapeConfig`` of a reduced config (status, fields, the H100 roofline,
  ``fits``), ``argument_gb`` equal to the bytes of the spec trees it was
  built from; the pod geometries' per-device bytes; skips.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.analysis.counts import count  # noqa: E402
from repro_torch.analysis.params import count_active_params  # noqa: E402
from repro_torch.analysis.roofline import (HW, model_flops,  # noqa: E402
                                           roofline_terms)
from repro_torch.configs import ShapeConfig, get_arch, get_shape  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import spec_tree_bytes, spec_tree_to_fake  # noqa: E402

FLOP_TOL = 0.01


def test_hardware_is_the_h100():
    assert HW.name == "NVIDIA H100 80GB HBM3" and HW.power_limit_w == 700
    assert (HW.peak_flops_bf16, HW.peak_flops_tf32, HW.peak_flops_f32) == (
        989e12, 495e12, 67e12)
    assert HW.hbm_bw == 3.35e12 and HW.hbm_per_chip == 80e9
    assert HW.link_bw == 450e9


def test_model_flops_and_roofline_formulas():
    cfg = get_arch("smollm-360m")
    n = count_active_params(cfg, build_model(cfg).param_specs())
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        s = get_shape(name)
        tokens = s.global_batch * (1 if s.is_decode else s.seq_len)
        mult = 6.0 if s.kind == "train" else 2.0
        assert model_flops(cfg, s, n, s.kind) == mult * n * tokens
    t = roofline_terms({"flops": 989e12, "bytes": 6.7e12,
                        "collective_bytes": 45e9}, chips=1)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.1)
    assert t["dominant"] == "memory" and t["bound_s"] == t["memory_s"]


def test_counts_of_a_known_step():
    """x (64, 128) @ w (128, 256), exp, sum, backward to w: 2·64·128·256
    flops forward and as many for dW; the peak holds the arguments."""
    with FakeTensorMode():
        x = torch.empty(64, 128)
        w = torch.empty(128, 256, requires_grad=True)

    def step(x, w):
        (x @ w).exp().sum().backward()
        return w.grad
    st = count(step, x, w)
    assert st.flops == 2 * (2 * 64 * 128 * 256)
    assert st.flops_by_op == {"mm": st.flops}
    args = (64 * 128 + 128 * 256) * 4
    # the product and its exp (saved for the backward) live at once
    assert st.peak_bytes >= args + 2 * 64 * 256 * 4
    assert st.bytes >= args + 64 * 256 * 4
    assert st.collectives == {} and st.collective_bytes == 0
    assert st.n_ops > 3


@pytest.mark.parametrize("name", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-370m"])
def test_prefill_flops_match_the_reference_hlo(name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.analysis.hlo import analyze_hlo
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.models import build_model as jax_build_model
    from repro.sharding import ParamSpec as JaxSpec

    B, S = 2, 64
    jm = jax_build_model(jax_get_arch(name).reduced())
    tm = build_model(get_arch(name).reduced())

    def sds(tree):
        return jax.tree.map(lambda ps: jax.ShapeDtypeStruct(
            ps.shape, jnp.dtype(ps.dtype)), tree,
            is_leaf=lambda x: isinstance(x, JaxSpec))
    js = JaxShape("p", S, B, "prefill")
    txt = jax.jit(lambda p, b: jm.prefill_fn(p, b, cache_len=S)).lower(
        sds(jm.param_specs()), sds(jm.input_specs(js, "prefill"))
    ).compile().as_text()
    want = analyze_hlo(txt).flops
    with FakeTensorMode():
        params = spec_tree_to_fake(tm.param_specs(), device="cpu")
        batch = spec_tree_to_fake(
            tm.input_specs(ShapeConfig("p", S, B, "prefill")), device="cpu")
    st = count(lambda p, b: tm.prefill_fn(p, b, cache_len=S), params, batch)
    assert abs(st.flops - want) <= FLOP_TOL * want, (
        f"{name}: counted {st.flops:.4g} against the HLO's {want:.4g}; "
        f"by op: {st.flops_by_op}")


FAMILIES = [("swb2000-blstm", "train"), ("smollm-360m", "train"),
            ("smollm-360m", "prefill"), ("smollm-360m", "decode"),
            ("granite-moe-3b-a800m", "train"), ("mamba2-370m", "decode"),
            ("hymba-1.5b", "prefill"), ("whisper-large-v3", "decode"),
            ("internvl2-2b", "train")]


def _expected_argument_bytes(cfg, shape):
    model = build_model(cfg)
    if shape.kind == "train":
        _, strategy, L, transport, lead, inputs = DR._train_parts(cfg, shape)
        params = spec_tree_bytes(model.param_specs(), None, lead)
        total = params * (2 if strategy.stale else 1)
        if strategy.replicated and transport.needs_state:
            total += 2 * spec_tree_bytes(DR._f32_specs(model.param_specs()),
                                         None, lead)
        return total + spec_tree_bytes(inputs)
    total = spec_tree_bytes(model.param_specs())
    if shape.kind == "prefill":
        return total + spec_tree_bytes(model.input_specs(shape))
    return (total + spec_tree_bytes(model.cache_specs(shape))
            + spec_tree_bytes(model.input_specs(shape)["tokens"]))


@pytest.mark.parametrize("name,kind", FAMILIES)
def test_dryrun_record_of_each_family(name, kind):
    cfg = get_arch(name).reduced()
    # the lstm's plain recurrence steps frame by frame: 8 frames suffice
    seq = 8 if cfg.family == "lstm" else 32
    shape = ShapeConfig(f"small_{kind}", seq, 4, kind)
    rec = DR.run_one(name, shape.name, device="cpu", cfg_override=cfg,
                     shape=shape)
    assert rec["status"] == "ok" and rec["mesh"] == "local_1xh100"
    assert rec["path"] == "plain" and rec["chips"] == 1
    mem = rec["memory"]
    assert rec["argument_bytes"] == _expected_argument_bytes(cfg, shape)
    assert mem["argument_gb"] == rec["argument_bytes"] / 1e9
    assert rec["peak_bytes"] >= rec["argument_bytes"]
    assert mem["temp_gb"] == pytest.approx(mem["peak_gb"]
                                           - mem["argument_gb"])
    assert mem["output_gb"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["counts"]["flops"] == rec["cost"]["flops"]
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["compute_s"] == rec["cost"]["flops"] / HW.peak_flops_bf16
    assert rec["hardware"]["name"] == HW.name
    assert rec["fits"] is True
    assert rec["params_total"] >= rec["params_active_nonembed"] > 0
    assert rec["model_flops"] == model_flops(
        cfg, shape, rec["params_active_nonembed"], kind)
    assert rec["model_flops_ratio"] == pytest.approx(
        rec["model_flops"] / rec["cost"]["flops"])
    if kind == "train":
        assert rec["strategy"] == cfg.train_strategy


def test_dryrun_skips_and_pod_geometries():
    rec = DR.run_one("swb2000-blstm", "decode_32k", device="cpu")
    assert rec["status"] == "skipped" and "skip_shapes" in rec["reason"]
    rec = DR.run_one("whisper-large-v3", "long_500k", device="cpu")
    assert rec["status"] == "skipped"
    cfg = get_arch("llama4-scout-17b-a16e")
    pod = DR.run_one(cfg.name, "train_4k", mesh="pod")
    multi = DR.run_one(cfg.name, "train_4k", mesh="multipod")
    assert pod["status"] == multi["status"] == "ok"
    assert (pod["chips"], multi["chips"]) == (256, 512)
    # every byte of the 213.5 GB of weights sits on some device: fsdp
    # shards the embed axis over data, the experts over data
    whole = spec_tree_bytes(build_model(cfg).param_specs())
    assert whole / 256 <= pod["memory"]["params_gb"] * 1e9 < whole
    assert pod["memory"]["argument_gb"] == pytest.approx(
        pod["memory"]["params_gb"] + pod["memory"]["state_gb"]
        + pod["memory"]["batch_gb"])
    assert multi["strategy"] == "hring"


def test_dryrun_cli_writes_a_record(tmp_path, capsys):
    cfg = get_arch("smollm-360m")
    DR.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--device",
             "cpu", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__local_1xh100.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["roofline"]["dominant"] == "memory"
    assert rec["fits"] is False        # 171.8 GB of KV cache at 32k x 128
    assert rec["hardware"]["name"] == HW.name
    assert rec["params_total"] == 361821120
    model = build_model(cfg)
    assert rec["argument_bytes"] == spec_tree_bytes(model.param_specs()) + \
        spec_tree_bytes(model.cache_specs(get_shape("decode_32k"))) + \
        spec_tree_bytes(model.input_specs(get_shape("decode_32k"))["tokens"])
    assert "all dry-runs passed" in capsys.readouterr().out
