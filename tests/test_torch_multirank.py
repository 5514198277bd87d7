"""The port's decentralized training with the learner axis split over
ranks, on the CPU.

Process groups of W = 2 and W = 4 gloo ranks are spawned with
``torch.multiprocessing`` (a file rendezvous under the test's temporary
directory, never a fixed TCP port; one thread a process), each rank
holding a contiguous block of L/W learners (``core/collective.py``).
One spawn a W runs every case and writes its results; the tests read
them:

* (a) the primitives: ``roll_learners`` for every shift in -L..L,
  ``gather_learners`` and ``ordered_sum_learners`` equal ``torch.roll``
  and ``mixing.ordered_sum`` over the gathered stack bit for bit; a
  learner count the world size does not divide raises;
* (b) the reduced ``swb2000-blstm``, 3 steps of each strategy at W ranks
  bit-identical to the one-process port (every state leaf and every
  metric: loss, grad norm, consensus, wire bytes), among them hring with
  pods as the blocks and pods that straddle them, and one learner a rank
  (the two-learner ring and the per-learner optimizer state read the
  global L); ``sc_psgd`` (one replica: each rank differentiates the sum
  of its frames' losses over the global frame count; also with 2
  microbatches) with the losses and
  ``softmax_b`` within 1e-5 relative and every other leaf, whose
  gradient passes bf16 intermediates, within one bf16 rounding step
  (2^-8) of its max-abs;
* (c) the port at W = 4 against the JAX package's ``setup_training`` on a
  forced 4-device CPU mesh (a subprocess with
  ``--xla_force_host_platform_device_count=4``: one learner a device),
  ad_psgd from the same init, 3 steps: losses within 2e-2 relative,
  params within 2e-2 of each leaf's max-abs (the tolerance of
  ``tests/test_torch_train_step.py``);
* (d) the train CLI at W = 2 prints W = 1's loss lines, also over an
  int8 wire in buckets and under a fault plan;
* (e) a W = 2 checkpoint resumes at W = 1 and a W = 1 one at W = 2, bit
  for bit with an uninterrupted run: the plain state, an elastic state
  (its staleness counters held whole on every rank) and a top-k state
  whose H-ring error-feedback rows are split with the blocks (pods
  inside them) or held whole (pods straddling them);
* (f) the coded, bucketed and elastic paths: an int8 ring with buckets
  that split a leaf, uniform over bf16, exp over top-k, hring with a
  bf16 intra-pod and a top-k inter-pod wire (pods inside the blocks and
  straddling them), the elastic step over the f32 and int8 rings (a
  straggler, a crash and rejoin, dropped edges and corrupted payloads),
  elastic hring with a pod down and elastic BMUF, at W = 2 and W = 4
  bit-identical to one process on every state leaf and every metric;
  the bytes a coded ring sends across ranks; at W = 4 the int8-ring,
  top-k-ring and elastic int8-ring runs within (c)'s tolerance of the
  JAX package's 4-device mesh from the same init (no corruption: the
  port's noise is its own draw).
"""
import contextlib
import dataclasses
import io
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
STEPS = 3
SEQ = 8
ROWS = 2                  # rows a learner
RANK_S = 120              # the most a spawn, or a rank's wait, may take
TOL = 2e-2                # the port against JAX (bf16 gradients)
SC_TOL = 1e-5             # sc_psgd across ranks: f32 rounding
BF16_STEP = 2.0 ** -8     # ... and one bf16 rounding step
ELASTIC_STEPS = 4         # a crash at step 1, the rejoin at step 3
BUCKET_MB = 1 / 16        # 64 KiB buckets: the widest leaves split in 5

# name -> (strategy, learners ("W": one a rank), optimizer, microbatches,
#          var_len, pod size ("block": L/W), bmuf block); "_chunked": the
#          sequence-chunked recompute (K1-chunk and K3's plain versions)
CASES = {
    "ad_psgd": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "sd_psgd": ("sd_psgd", 4, "momentum", 2, True, 0, 0),
    "hring_blocks": ("hring", 8, "sgd", 1, True, "block", 0),
    "hring_straddle": ("hring", 12, "sgd", 1, True, 4, 0),
    "ad_psgd_exp": ("ad_psgd_exp", 8, "sgd", 1, True, 0, 0),
    "bmuf": ("bmuf", 4, "sgd", 1, True, 0, 2),
    "downpour": ("downpour", 4, "sgd", 1, False, 0, 0),
    "sc_psgd_replicated": ("sc_psgd_replicated", 4, "sgd", 1, True, 0, 0),
    "one_a_rank": ("ad_psgd", "W", "adam", 1, True, 0, 0),
    "ad_psgd_chunked": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "sc_psgd": ("sc_psgd", 1, "sgd", 1, True, 0, 0),
    "sc_psgd_micro": ("sc_psgd", 1, "sgd", 2, True, 0, 0),
    # (f) the coded, bucketed and elastic paths
    "ring_int8_buckets": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "uniform_bf16": ("sd_psgd", 4, "momentum", 1, True, 0, 0),
    "exp_topk": ("ad_psgd_exp", 8, "sgd", 1, True, 0, 0),
    "hring_bf16_topk_blocks": ("hring", 8, "sgd", 1, True, "block", 0),
    "hring_bf16_topk_straddle": ("hring", 12, "sgd", 1, True, 4, 0),
    "elastic_ring_f32": ("ad_psgd", 8, "adam", 1, True, 0, 0),
    "elastic_ring_int8": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "elastic_hring_int8": ("hring", 8, "sgd", 1, True, 2, 0),
    "elastic_bmuf": ("bmuf", 4, "momentum", 1, False, 0, 2),
}
HRING_CODED = dict(comm_intra_wire="bf16", comm_wire="topk",
                   comm_topk_frac=0.1)
# name -> the cfg's comm_* knobs of a case
COMM = {
    "ring_int8_buckets": dict(comm_wire="int8", comm_bucket_mb=BUCKET_MB),
    "uniform_bf16": dict(comm_topology="uniform", comm_wire="bf16"),
    "exp_topk": dict(comm_wire="topk", comm_topk_frac=0.1),
    "hring_bf16_topk_blocks": HRING_CODED,
    "hring_bf16_topk_straddle": HRING_CODED,
    "elastic_ring_f32": dict(comm_staleness_lambda=0.2),
    "elastic_ring_int8": dict(comm_wire="int8", comm_bucket_mb=BUCKET_MB,
                              comm_staleness_lambda=0.2),
    "elastic_hring_int8": dict(comm_wire="int8"),
    "jax_int8_ring": dict(comm_wire="int8"),
    "jax_topk_ring": dict(comm_wire="topk", comm_topk_frac=0.1),
    "jax_elastic_int8_ring": dict(comm_wire="int8"),
}
RING_FAULTS = dict(seed=3, stragglers="0:2", departures="1:1:3",
                   drop_prob=0.2, corrupt_prob=0.3, corrupt_scale=0.1)
# name -> the FaultPlan of an elastic case (the elastic step, 4 steps)
PLANS = {
    "elastic_ring_f32": RING_FAULTS,
    "elastic_ring_int8": RING_FAULTS,
    "elastic_hring_int8": dict(departures="2:1:3,3:1:3"),
    "elastic_bmuf": dict(stragglers="3:2", departures="1:1:3"),
    "jax_elastic_int8_ring": dict(stragglers="0:2", departures="1:1:3"),
}
# one replica: each rank's rows of the global batch, held to rounding
SC_CASES = ("sc_psgd", "sc_psgd_micro")
CLI = ["--reduced", "--device", "cpu", "--learners", "4", "--var-len",
       "--seq-len", str(SEQ), "--log-every", "1"]
FAULT_FLAGS = ["--fault-stragglers", "0:2", "--fault-departures", "1:1:3",
               "--fault-drop-prob", "0.2", "--comm-wire", "int8"]
HRING_FLAGS = ["--strategy", "hring", "--comm-intra-wire", "bf16",
               "--comm-wire", "topk", "--comm-topk-frac", "0.1"]
# (d) name -> the CLI's flags, its steps
CLI_RUNS = {
    "plain": ([], STEPS),
    "int8_buckets": (["--comm-wire", "int8", "--comm-bucket-mb", "1"],
                     STEPS),
    "faults": (FAULT_FLAGS, ELASTIC_STEPS),
}
# (e) name -> the CLI's flags, the steps of the saved run and of the
# uninterrupted one
CKPT_RUNS = {
    "plain": ([], 2, STEPS),
    "elastic_int8": (FAULT_FLAGS, 2, ELASTIC_STEPS),
    "topk_pods_in_blocks": (HRING_FLAGS + ["--comm-pod-size", "2"], 2,
                            STEPS),
    "topk_pods_straddle": (HRING_FLAGS + ["--learners", "12",
                                          "--comm-pod-size", "4"], 2,
                           STEPS),
}

def _case_args(name, W):
    strategy, L, opt, micro, var_len, pod, block = CASES[name]
    L = W if L == "W" else L
    pod = L // W if pod == "block" else pod
    return strategy, L, opt, micro, var_len, pod, block


def _plan(name, L):
    from repro_torch.core.faults import (FaultPlan, parse_departures,
                                         parse_stragglers)

    kw = dict(PLANS[name])
    kw["stragglers"] = parse_stragglers(kw.get("stragglers", ""))
    kw["departures"] = parse_departures(kw.get("departures", ""))
    return FaultPlan(L, **kw)


def _trajectory(name, W, params=None):
    """Steps of one case, at the learners and pods it has at W, on this
    process's block (the whole stack in one process): (state, per-step
    metrics as floats, the state's keys every rank holds whole).
    ``params``: start params (this block of them) instead of the seed-0
    init."""
    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.models import lstm as LS
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.optim.schedules import paper_recipe
    from repro_torch.params import init_params

    strategy, L, opt, micro, var_len, pod, block = _case_args(name, W)
    cfg = get_arch("swb2000-blstm").reduced()
    cfg = dataclasses.replace(cfg, **COMM.get(name, {}))
    if pod:
        cfg = dataclasses.replace(cfg, comm_pod_size=pod)
    if name.endswith("_chunked"):
        cfg = dataclasses.replace(cfg, lstm_seq_chunk=3)
    strat = ST.get_strategy(strategy)
    if block:
        strat = dataclasses.replace(strat, block_size=block)
    transport = ST.transport_from_cfg(cfg, strat)
    optimizer = get_optimizer(opt)
    plan = _plan(name, L) if name in PLANS else None
    kw = dict(n_learners=L, microbatches=micro, transport=transport,
              with_consensus=True, with_grad_norm=True)
    steps = ELASTIC_STEPS if plan else STEPS
    args = (strat, lambda p, b, **kw: LS.loss_train(cfg, p, b, device="cpu",
                                                    **kw),
            optimizer, paper_recipe(steps, 0.05, 0.2))
    if plan:
        step = ST.make_elastic_train_step(
            *args, fault_seed=plan.seed,
            with_corruption=plan.corrupt_prob > 0, **kw)
    else:
        step = ST.make_train_step(*args, **kw)
    if params is None:
        params = init_params(LS.param_specs(cfg), 0, "cpu")
        if strat.replicated:
            params = ST.stack_for_learners(params, L)
    init = ST.init_elastic_state if plan else ST.init_state
    state = init(strat, params, optimizer, transport=transport)
    ds = make_dataset(cfg, seq_len=SEQ, batch=ROWS * max(L, 4), seed=0,
                      var_len=var_len)
    metrics = []
    for k in range(steps):
        faults = (plan.step_inputs(k),) if plan else ()
        state, m = step(state, ds.batch_at(k), *faults)
        metrics.append({key: float(v) for key, v in m.items()})
    whole = (ST.whole_keys(state, transport) if strat.replicated
             else ("step",))
    return state, metrics, whole


def _gathered_state(state, replicated=True, whole=("step", "staleness")):
    """The global state of this rank's: every split leaf gathered; the
    keys in ``whole`` (held whole by every rank) as they are."""
    from repro_torch.core import collective as C

    if not replicated:
        return state
    return {k: v if k in whole else C.gather_tree(v)
            for k, v in state.items()}


def _coded_sent():
    """The bytes one mix over an int8 ring and over a bf16 ring sends
    from this rank (``collective.sent_bytes``), on the reduced params
    stacked over 8 learners; and whether the former refusals across
    ranks (the coded mixer, the elastic step) are gone."""
    from repro_torch.configs import get_arch
    from repro_torch.core import collective as C
    from repro_torch.core import strategies as ST
    from repro_torch.core.transport import Transport
    from repro_torch.models import lstm as LS
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.params import init_params

    cfg = get_arch("swb2000-blstm").reduced()
    params = ST.stack_for_learners(init_params(LS.param_specs(cfg), 0,
                                               "cpu"), 8)
    out = {}
    for wire, bucket in (("int8", 65536), ("bf16", 0), ("f32", 65536)):
        t = Transport(topology="ring", wire=wire, bucket_bytes=bucket)
        C.reset_sent()
        t.make_mixer(8)(params, 0, {})
        out[wire] = dict(C.sent_bytes)
    ST.make_elastic_train_step(ST.get_strategy("ad_psgd"), None,
                               get_optimizer("sgd"), None, n_learners=8)
    try:
        ST.make_elastic_train_step(ST.get_strategy("ad_psgd"), None,
                                   get_optimizer("sgd"), None,
                                   n_learners=C.world()[1] + 1)
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def _primitives(W):
    """(a) on this rank: name -> None when it held, else what differed."""
    from repro_torch.core import collective as C
    from repro_torch.core import mixing

    out = {}
    L = 8
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        full = torch.randn(L, 3, 5, generator=g).to(dtype)
        mine = C.block_rows(full).clone()
        bad = [s for s in range(-L, L + 1) if not torch.equal(
            C.roll_learners(mine, s), C.block_rows(torch.roll(full, s, 0)))]
        out[f"roll_{dtype}"] = bad or None
        out[f"gather_{dtype}"] = (None if torch.equal(
            C.gather_learners(mine), full) else "gather differs")
    q = torch.randint(-127, 128, (L, 9), generator=g, dtype=torch.int8)
    sc = torch.randn(L, 3, generator=g)
    packed = C.roll_learners(C.pack_rows(C.block_rows(q), C.block_rows(sc)),
                             3)
    back = C.unpack_rows(packed, [(torch.int8, (9,)), (torch.float32, (3,))])
    out["pack_roll"] = (None if torch.equal(back[0], C.block_rows(
        torch.roll(q, 3, 0))) and torch.equal(back[1], C.block_rows(
            torch.roll(sc, 3, 0))) else "packed rows differ")
    f = torch.randn(L, 7, 2, generator=g)
    got = C.ordered_sum_learners(C.block_rows(f).clone())
    out["ordered_sum"] = (None if torch.equal(got, mixing.ordered_sum(f, 0))
                          else "ordered sum differs")
    try:
        C.learner_block(W + W // 2)
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = None if "do not split" in str(e) else str(e)
    return out


def _launch_view(mesh, multihost):
    """What ``launch/mesh`` and ``launch/multihost`` say of this rank:
    the mesh's axes, devices and own device, the learner block of 8, and
    the rows ``make_global_batch`` keeps of an 8-row batch."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import rules_for

    m = mesh.make_local_mesh()
    rows = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    rules = rules_for(get_arch("swb2000-blstm").reduced(), m)
    got = multihost.make_global_batch({"labels": rows}, m, rules,
                                      {"labels": ("batch", "seq")})
    return dict(shape=m.shape, devices=[str(d) for d in m.devices],
                device=str(m.device), block=multihost.learner_block(8),
                rows=got["labels"].tolist(),
                placement=multihost.placement().describe())


def _cli(argv):
    """The train CLI's global state (this rank's gathered) and standard
    output."""
    from repro_torch.core import strategies as ST
    from repro_torch.launch import train as TT

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TT.main(argv)
    state = out["state"]
    return _gathered_state(state, whole=ST.whole_keys(
        state, out["meta"]["transport"])), buf.getvalue()


def _loss_lines(text):
    """The CLI's loss numbers: every step line's and the final line."""
    keep = []
    for line in text.splitlines():
        if line.startswith("step "):
            keep.append(line.split("loss ")[1].split()[0])
        elif line.startswith("final loss"):
            keep.append(line)
    return keep


def _ckpt_argv(name, ckpt, steps, resume=False):
    flags, saved, _ = CKPT_RUNS[name]
    tail = ["--resume"] if resume else ["--ckpt-every", str(saved)]
    return CLI + flags + ["--steps", str(steps), "--ckpt-dir", ckpt] + tail


def _worker(rank, W, tmp, jax_init):
    import torch.distributed as dist

    from repro_torch.core import collective as C
    from repro_torch.core import strategies as ST
    from repro_torch.launch import mesh, multihost

    torch.set_num_threads(1)
    # a collective that waits past RANK_S raises in the rank
    assert multihost.initialize(init_method=f"file://{tmp}/rdv{W}",
                                num_processes=W, process_id=rank,
                                device="cpu", timeout=RANK_S)
    try:
        res = {"primitives": _primitives(W), "cases": {},
               "launch": _launch_view(mesh, multihost),
               "coded": _coded_sent()}
        for name in CASES:
            if name in JAX_CASES:
                continue
            state, metrics, whole = _trajectory(name, W)
            replicated = ST.get_strategy(CASES[name][0]).replicated
            res["cases"][name] = (_gathered_state(state, replicated, whole),
                                  metrics)
        if W == 2:
            res["cli"] = {name: _cli(CLI + flags + ["--steps", str(steps)])
                          for name, (flags, steps) in CLI_RUNS.items()}
            res["resumed"] = {}
            for name, (_, saved, total) in CKPT_RUNS.items():
                _cli(_ckpt_argv(name, f"{tmp}/ck_{name}_w2", saved))
                res["resumed"][name] = _cli(_ckpt_argv(
                    name, f"{tmp}/ck_{name}_w1", total - saved, True))[0]
        if jax_init is not None:
            from repro_torch.params import from_jax_state

            with open(jax_init, "rb") as f:
                init = pickle.load(f)
            params = C.local_block(from_jax_state(init)["params"])
            res["jax"] = {}
            for name in JAX_CASES:
                state, metrics, whole = _trajectory(name, W, params)
                res["jax"][name] = (_gathered_state(state, True, whole),
                                    metrics)
        if rank == 0:
            torch.save(res, f"{tmp}/w{W}.pt")
    finally:
        dist.destroy_process_group()


# the JAX comparisons' cases: one learner a rank at W = 4, from the JAX
# run's init
JAX_CASES = {
    "jax_ad_psgd": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "jax_int8_ring": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "jax_topk_ring": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
    "jax_elastic_int8_ring": ("ad_psgd", 4, "sgd", 1, True, 0, 0),
}
CASES.update(JAX_CASES)

JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.core.faults import (FaultPlan, parse_departures,
                                   parse_stragglers)
    from repro.data import make_dataset
    from repro.launch.mesh import make_local_mesh
    from repro.launch.train import setup_training
    from repro.optim.schedules import paper_recipe

    out = sys.argv[1]
    base = get_arch("swb2000-blstm").reduced()
    mesh = make_local_mesh(data=len(jax.devices()))
    ds = make_dataset(base, seq_len={seq}, batch={batch}, seed=0,
                      var_len=True)
    runs = {{}}
    for name, knobs, plan in {runs}:
        cfg = dataclasses.replace(base, **knobs)
        steps = {elastic_steps} if plan else {steps}
        if plan:
            plan = FaultPlan(4, stragglers=parse_stragglers(plan[0]),
                             departures=parse_departures(plan[1]))
        state, step, meta = setup_training(
            cfg, mesh, strategy_name="ad_psgd", n_learners=4, seed=0,
            lr_schedule=paper_recipe(steps, 0.05, 0.2),
            elastic=plan is not None)
        leaf = state["params"]["softmax_w"]
        if name == "jax_ad_psgd":
            with open(out + ".init", "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, state), f)
            os.replace(out + ".init", out + ".init.pkl")
        losses = []
        for k in range(steps):
            batch = {{key: jnp.asarray(v)
                     for key, v in ds.batch_at(k).items()}}
            faults = ()
            if plan:
                faults = ({{key: jnp.asarray(v) for key, v
                           in plan.step_inputs(k).items()}},)
            state, m = step(state, batch, *faults)
            losses.append(float(m["loss"]))
        runs[name] = dict(losses=losses, sharding=str(leaf.sharding),
                          params=jax.tree.map(np.asarray, state["params"]))
    with open(out, "wb") as f:
        pickle.dump(dict(devices=len(jax.devices()), runs=runs), f)
""").format(steps=STEPS, elastic_steps=ELASTIC_STEPS, seq=SEQ,
           batch=ROWS * 4, runs=repr([
               (name, COMM.get(name, {}),
                (PLANS[name]["stragglers"], PLANS[name]["departures"])
                if name in PLANS else None) for name in JAX_CASES]))


def _spawn(W, *args):
    """Start W ranks of :func:`_worker`; :func:`_join` waits for them."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_worker, args=(W,) + args, nprocs=W,
                             join=False, start_method="spawn")
    return ctx, W, time.monotonic() + RANK_S


def _join(spawned):
    """The ranks joined within RANK_S seconds of their start (a rank that
    raises raises here; one still running then is killed)."""
    ctx, W, deadline = spawned
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{W} ranks still running after {RANK_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    jax_out = tmp / "jax.pkl"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(jax_out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # (d) as a user launches it: torchrun's own rendezvous on a free
    # localhost port, the ranks reading its environment
    run_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
        + CLI + ["--steps", str(STEPS)],
        env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # (e)'s W = 1 checkpoints, read by the W = 2 ranks
        for name, (_, saved, _) in CKPT_RUNS.items():
            _cli(_ckpt_argv(name, str(tmp / f"ck_{name}_w1"), saved))
        # the one-process runs, at the learner count and pods each case
        # has at W, while the ranks run
        ranks = _spawn(2, str(tmp), None)
        refs = {(name, 2): _trajectory(name, 2)[:2] for name in CASES
                if name not in JAX_CASES}
        _join(ranks)
        # the W = 4 ranks start from the JAX run's init
        init = Path(str(jax_out) + ".init.pkl")
        deadline = time.monotonic() + RANK_S
        while (not init.exists() and jax_proc.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert init.exists(), jax_proc.stdout.read().decode()
        ranks = _spawn(4, str(tmp), str(init))
        refs.update({(name, 4): _trajectory(name, 4)[:2] for name in CASES
                     if name not in JAX_CASES})
        cli = {name: _cli(CLI + flags + ["--steps", str(steps)])
               for name, (flags, steps) in CLI_RUNS.items()}
        uninterrupted = {name: _cli(CLI + flags + ["--steps", str(total)])[0]
                         for name, (flags, _, total) in CKPT_RUNS.items()}
        resumed_w1 = {name: _cli(_ckpt_argv(
            name, str(tmp / f"ck_{name}_w2"), total - saved, True))[0]
            for name, (_, saved, total) in CKPT_RUNS.items()}
        _join(ranks)
        got = {W: torch.load(tmp / f"w{W}.pt", weights_only=False)
               for W in WORLDS}
        with open(init, "rb") as f:
            jax_init = pickle.load(f)
        out, _ = jax_proc.communicate(timeout=RANK_S)
        run_out, _ = run_proc.communicate(timeout=RANK_S)
    finally:
        torch.set_num_threads(threads)
        for proc in (jax_proc, run_proc):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert jax_proc.returncode == 0, out.decode()
    assert run_proc.returncode == 0, run_out.decode()
    with open(jax_out, "rb") as f:
        jax_res = pickle.load(f)
    return dict(got=got, refs=refs, cli=cli, torchrun=run_out.decode(),
                uninterrupted=uninterrupted, resumed_w1=resumed_w1,
                jax=jax_res, jax_init=jax_init)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same(got, want):
    a, b = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("what", ["roll_torch.bfloat16", "roll_torch.float32",
                                  "gather_torch.bfloat16",
                                  "gather_torch.float32", "ordered_sum",
                                  "uneven", "pack_roll"])
def test_collective_primitives(runs, W, what):
    assert runs["got"][W]["primitives"][what] is None


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", [n for n in CASES if n not in JAX_CASES])
def test_split_learners_match_one_process(runs, W, name):
    got_state, got_metrics = runs["got"][W]["cases"][name]
    want_state, want_metrics = runs["refs"][name, W]
    if name not in SC_CASES:
        _assert_same(got_state, want_state)
        assert got_metrics == want_metrics
        return
    # one replica: each rank differentiates the sum of its frames' losses
    # over the global frame count (each frame's cotangent is W = 1's) on
    # its rows, the gradients added in rank order.  The loss and the f32
    # leaf the f32 logits reach directly (softmax_b) hold f32 rounding;
    # every other gradient is a rank's partial sum rounded to bf16, or
    # passes bf16 intermediates (the bottleneck's and each layer's dx),
    # so a parameter's bf16 rounding can flip at single elements: one
    # bf16 step of the leaf's max-abs
    for (path, x), (_, y) in zip(_leaves(got_state["params"]),
                                 _leaves(want_state["params"])):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        err = float((x.float() - y.float()).abs().max()) / (
            float(y.float().abs().max()) + 1e-12)
        assert err <= (SC_TOL if path == "/softmax_b" else BF16_STEP), (
            path, err)
    for g, w in zip(got_metrics, want_metrics):
        assert abs(g["loss"] - w["loss"]) <= SC_TOL * abs(w["loss"])


def _against_jax(runs, name):
    """The port's W = 4 run of ``name`` against the JAX package's
    4-device mesh from the same init: losses within TOL relative, params
    within TOL of each leaf's max-abs."""
    from repro_torch.params import from_jax_state

    jax_res = runs["jax"]
    want_run = jax_res["runs"][name]
    assert jax_res["devices"] == 4
    assert "'data'" in want_run["sharding"], want_run["sharding"]
    state, metrics = runs["got"][4]["jax"][name]
    assert len(metrics) == len(want_run["losses"])
    for k, (g, want) in enumerate(zip(metrics, want_run["losses"])):
        assert abs(g["loss"] - want) <= TOL * abs(want), (k, g, want)
    want = from_jax_state({"params": want_run["params"]})["params"]
    for (path, x), (_, y) in zip(_leaves(state["params"]), _leaves(want)):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        err = float((x.float() - y.float()).abs().max()) / (
            float(y.float().abs().max()) + 1e-12)
        assert err <= TOL, (path, err)
    return state, metrics


def test_four_ranks_match_the_jax_four_device_mesh(runs):
    """The JAX package lays its learner axis over 4 devices, one learner
    each; the port over 4 ranks, from the same init."""
    from repro_torch.params import from_jax_state

    _against_jax(runs, "jax_ad_psgd")
    # and the port's own start was the JAX init, cut into blocks
    init = from_jax_state(runs["jax_init"])
    assert init["params"]["softmax_w"].shape[0] == 4


@pytest.mark.parametrize("name", ["jax_int8_ring", "jax_topk_ring",
                                  "jax_elastic_int8_ring"])
def test_coded_and_elastic_four_ranks_match_the_jax_mesh(runs, name):
    """(f) over the int8 and top-k rings and the elastic int8 ring (a
    straggler, a crash at step 1 and its rejoin at step 3): the JAX
    package's sharded step against the port's over 4 ranks."""
    state, metrics = _against_jax(runs, name)
    if name.startswith("jax_elastic"):
        assert [m["n_active"] for m in metrics] == [4.0, 3.0, 3.0, 4.0]
        assert state["staleness"].shape == (4,)
    if name == "jax_topk_ring":
        assert state["comm"]["residual"]["softmax_w"].shape[0] == 4


def test_cli_at_two_ranks_prints_the_one_process_losses(runs):
    state, text = runs["got"][2]["cli"]["plain"]
    want_state, want_text = runs["cli"]["plain"]
    assert _loss_lines(text) == _loss_lines(want_text)
    assert any(line.startswith("final loss") for line in text.splitlines())
    assert "world: 2 ranks over gloo" in text
    _assert_same(state, want_state)


@pytest.mark.parametrize("name", [n for n in CLI_RUNS if n != "plain"])
def test_coded_and_elastic_cli_at_two_ranks_prints_the_one_process_losses(
        runs, name):
    """The CLI's ``--comm-wire int8 --comm-bucket-mb`` and ``--fault-*``
    runs at W = 2: W = 1's loss lines (the fault run's ``act n/4 stale``
    trail included) and state."""
    state, text = runs["got"][2]["cli"][name]
    want_state, want_text = runs["cli"][name]
    assert _loss_lines(text) == _loss_lines(want_text)
    assert len(_loss_lines(text)) == CLI_RUNS[name][1] + 1
    assert "world: 2 ranks over gloo" in text
    if name == "faults":
        trail = [line.split(" act ")[1] for line in text.splitlines()
                 if " act " in line]
        assert trail == [line.split(" act ")[1] for line in
                         want_text.splitlines() if " act " in line]
        assert "act 3/4" in text and "FaultPlan(L=4" in text
    _assert_same(state, want_state)


@pytest.mark.parametrize("W", WORLDS)
def test_coded_ring_sends_its_coded_rows(runs, W):
    """``collective.sent_bytes`` of one ring mix over 8 learners: each
    rank sends two rows of every leaf a mix (its edge rows, one to each
    neighbouring block), coded: an int8 row with a 4-B scale per bucket,
    a bf16 row, an f32 row of a bucketed f32 wire."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategies import _leaves as spec_leaves
    from repro_torch.core.transport import _bucket_sizes
    from repro_torch.models import lstm as LS

    sizes = [int(np.prod(s.shape)) for s in spec_leaves(LS.param_specs(
        get_arch("swb2000-blstm").reduced()))]
    want = {"int8": sum(2 * (n + 4 * len(_bucket_sizes(n, 65536)))
                        for n in sizes),
            "bf16": sum(2 * 2 * n for n in sizes),
            "f32": sum(2 * 4 * n for n in sizes)}
    got = runs["got"][W]["coded"]
    for wire, n in want.items():
        assert got[wire] == {"roll": n, "gather": 0, "sum": 0}, wire


@pytest.mark.parametrize("W", WORLDS)
def test_elastic_step_and_coded_wires_split_over_ranks(runs, W):
    """The elastic step and the coded mixers build at W > 1 (they raised
    a ValueError before); a learner count W does not divide still
    raises, naming it."""
    assert runs["got"][W]["coded"]["uneven"] == (
        f"{W + 1} learners do not split over {W} ranks: the world size "
        f"must divide the learner count")


def test_torchrun_cli_at_two_ranks_prints_the_one_process_losses(runs):
    """The CLI under ``torchrun``: ``multihost.initialize`` from the
    launcher's environment (a tcp rendezvous), rank 0 printing W = 1's
    loss lines."""
    text = runs["torchrun"]
    assert "world: 2 ranks over gloo, 4 learners (2 a rank)" in text, text
    assert _loss_lines(text) == _loss_lines(runs["cli"]["plain"][1]), text


@pytest.mark.parametrize("W", WORLDS)
def test_launch_describes_the_world(runs, W):
    """``launch/mesh.make_local_mesh`` and ``launch/multihost`` on rank 0
    of W: the mesh's 'data' axis is the ranks, its devices theirs; the
    learner block and the batch rows are rank 0's."""
    view = runs["got"][W]["launch"]
    assert view["shape"] == {"data": W, "model": 1}
    assert view["devices"] == ["cpu"] * W and view["device"] == "cpu"
    assert view["block"] == (0, 8 // W)
    rows = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)[:8 // W]
    assert view["rows"] == rows.tolist()
    assert view["placement"] == (f"gloo: rank 0 of {W} on cpu, payloads "
                                 f"in host memory")


@pytest.mark.parametrize("saved_at", [1, 2])
def test_checkpoint_resumes_across_world_sizes(runs, saved_at):
    """Two steps saved at one world size, the third taken at the other,
    equal three uninterrupted steps at W = 1."""
    uninterrupted = runs["uninterrupted"]["plain"]
    resumed = (runs["got"][2]["resumed"]["plain"] if saved_at == 1
               else runs["resumed_w1"]["plain"])
    _assert_same(resumed, uninterrupted)


@pytest.mark.parametrize("saved_at", [1, 2])
@pytest.mark.parametrize("name", [n for n in CKPT_RUNS if n != "plain"])
def test_elastic_and_ef_checkpoints_resume_across_world_sizes(runs, name,
                                                              saved_at):
    """An elastic int8 state (2 steps saved, 2 more resumed through the
    crash window and the rejoin) and a top-k H-ring state whose EF rows
    are split with the blocks or held whole (pods straddling them), saved
    at one world size and resumed at the other, equal the uninterrupted
    run at W = 1."""
    uninterrupted = runs["uninterrupted"][name]
    resumed = (runs["got"][2]["resumed"][name] if saved_at == 1
               else runs["resumed_w1"][name])
    _assert_same(resumed, uninterrupted)
    if name == "elastic_int8":
        assert uninterrupted["staleness"].shape == (4,)
    else:
        pods = 3 if name == "topk_pods_straddle" else 2
        assert uninterrupted["comm"]["estimate"]["softmax_w"].shape[0] == \
            pods
        assert uninterrupted["comm"]["estimate"]["softmax_w"].abs().sum() > 0
