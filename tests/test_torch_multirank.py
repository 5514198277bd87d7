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
* (d) the train CLI at W = 2 prints W = 1's loss lines;
* (e) a W = 2 checkpoint resumes at W = 1 and a W = 1 one at W = 2, bit
  for bit with an uninterrupted run.
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
}
# one replica: each rank's rows of the global batch, held to rounding
SC_CASES = ("sc_psgd", "sc_psgd_micro")
CLI = ["--reduced", "--device", "cpu", "--learners", "4", "--var-len",
       "--seq-len", str(SEQ), "--log-every", "1"]


def _case_args(name, W):
    strategy, L, opt, micro, var_len, pod, block = CASES[name]
    L = W if L == "W" else L
    pod = L // W if pod == "block" else pod
    return strategy, L, opt, micro, var_len, pod, block


def _trajectory(name, W, state=None):
    """Steps of one case, at the learners and pods it has at W, on this
    process's block (the whole stack in one process): (state, per-step
    metrics as floats).  ``state``: a start state (this block of it)
    instead of the seed-0 init."""
    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.models import lstm as LS
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.optim.schedules import paper_recipe
    from repro_torch.params import init_params

    strategy, L, opt, micro, var_len, pod, block = _case_args(name, W)
    cfg = get_arch("swb2000-blstm").reduced()
    if pod:
        cfg = dataclasses.replace(cfg, comm_pod_size=pod)
    if name.endswith("_chunked"):
        cfg = dataclasses.replace(cfg, lstm_seq_chunk=3)
    strat = ST.get_strategy(strategy)
    if block:
        strat = dataclasses.replace(strat, block_size=block)
    transport = ST.transport_from_cfg(cfg, strat)
    optimizer = get_optimizer(opt)
    step = ST.make_train_step(
        strat, lambda p, b, **kw: LS.loss_train(cfg, p, b, device="cpu",
                                                **kw),
        optimizer, paper_recipe(STEPS, 0.05, 0.2), n_learners=L,
        microbatches=micro, transport=transport, with_consensus=True,
        with_grad_norm=True)
    if state is None:
        params = init_params(LS.param_specs(cfg), 0, "cpu")
        if strat.replicated:
            params = ST.stack_for_learners(params, L)
        state = ST.init_state(strat, params, optimizer, transport=transport)
    ds = make_dataset(cfg, seq_len=SEQ, batch=ROWS * max(L, 4), seed=0,
                      var_len=var_len)
    metrics = []
    for k in range(STEPS):
        state, m = step(state, ds.batch_at(k))
        metrics.append({key: float(v) for key, v in m.items()})
    return state, metrics


def _gathered_state(state, replicated=True):
    from repro_torch.core import collective as C

    if not replicated:
        return state
    return {k: v if k == "step" else C.gather_tree(v)
            for k, v in state.items()}


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
    """The train CLI's state and standard output."""
    from repro_torch.launch import train as TT

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TT.main(argv)
    return out["state"], buf.getvalue()


def _loss_lines(text):
    """The CLI's loss numbers: every step line's and the final line."""
    keep = []
    for line in text.splitlines():
        if line.startswith("step "):
            keep.append(line.split("loss ")[1].split()[0])
        elif line.startswith("final loss"):
            keep.append(line)
    return keep


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
               "launch": _launch_view(mesh, multihost)}
        for name in CASES:
            state, metrics = _trajectory(name, W)
            replicated = ST.get_strategy(CASES[name][0]).replicated
            res["cases"][name] = (_gathered_state(state, replicated),
                                  metrics)
        if W == 2:
            state, text = _cli(CLI + ["--steps", str(STEPS)])
            res["cli"] = (_gathered_state(state), text)
            ck_a, ck_b = f"{tmp}/ck_w2", f"{tmp}/ck_w1"
            _cli(CLI + ["--steps", "2", "--ckpt-dir", ck_a,
                        "--ckpt-every", "2"])
            state, _ = _cli(CLI + ["--steps", "1", "--ckpt-dir", ck_b,
                                   "--resume"])
            res["resumed"] = _gathered_state(state)
        if jax_init is not None:
            from repro_torch.params import from_jax_state

            with open(jax_init, "rb") as f:
                init = pickle.load(f)
            state = C.local_block(from_jax_state(init))
            state, metrics = _trajectory("jax_ad_psgd", W, state)
            res["jax"] = (_gathered_state(state), metrics)
        if rank == 0:
            torch.save(res, f"{tmp}/w{W}.pt")
    finally:
        dist.destroy_process_group()


# the JAX comparison's case: ad_psgd over one learner a rank at W = 4
CASES["jax_ad_psgd"] = ("ad_psgd", 4, "sgd", 1, True, 0, 0)

JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.data import make_dataset
    from repro.launch.mesh import make_local_mesh
    from repro.launch.train import setup_training
    from repro.optim.schedules import paper_recipe

    out = sys.argv[1]
    cfg = get_arch("swb2000-blstm").reduced()
    mesh = make_local_mesh(data=len(jax.devices()))
    state, step, meta = setup_training(
        cfg, mesh, strategy_name="ad_psgd", n_learners=4, seed=0,
        lr_schedule=paper_recipe({steps}, 0.05, 0.2))
    leaf = state["params"]["softmax_w"]
    with open(out + ".init", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, state), f)
    import os
    os.replace(out + ".init", out + ".init.pkl")
    ds = make_dataset(cfg, seq_len={seq}, batch={batch}, seed=0,
                      var_len=True)
    losses = []
    for k in range({steps}):
        batch = {{key: jnp.asarray(v) for key, v in ds.batch_at(k).items()}}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    with open(out, "wb") as f:
        pickle.dump(dict(losses=losses, devices=len(jax.devices()),
                         sharding=str(leaf.sharding),
                         params=jax.tree.map(np.asarray, state["params"])),
                    f)
""").format(steps=STEPS, seq=SEQ, batch=ROWS * 4)


def _spawn(W, *args):
    """W ranks of :func:`_worker`, joined within RANK_S seconds (a rank
    that raises raises here; one still running then is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_worker, args=(W,) + args, nprocs=W,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_S
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
        # (e)'s W = 1 checkpoint, read by the W = 2 ranks
        _cli(CLI + ["--steps", "2", "--ckpt-dir", str(tmp / "ck_w1"),
                    "--ckpt-every", "2"])
        _spawn(2, str(tmp), None)
        # the W = 4 ranks start from the JAX run's init
        init = Path(str(jax_out) + ".init.pkl")
        deadline = time.monotonic() + RANK_S
        while (not init.exists() and jax_proc.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert init.exists(), jax_proc.stdout.read().decode()
        _spawn(4, str(tmp), str(init))
        got = {W: torch.load(tmp / f"w{W}.pt", weights_only=False)
               for W in WORLDS}
        # the one-process runs, at the learner count and pods each case
        # has at W
        refs = {(name, W): _trajectory(name, W) for W in WORLDS
                for name in CASES if name != "jax_ad_psgd"}
        cli_state, cli_text = _cli(CLI + ["--steps", str(STEPS)])
        resumed_w1, _ = _cli(CLI + ["--steps", "1", "--ckpt-dir",
                                    str(tmp / "ck_w2"), "--resume"])
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
    return dict(got=got, refs=refs, cli=(cli_state, cli_text),
                torchrun=run_out.decode(),
                resumed_w1=resumed_w1, jax=jax_res, jax_init=jax_init)


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
                                  "uneven"])
def test_collective_primitives(runs, W, what):
    assert runs["got"][W]["primitives"][what] is None


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", [n for n in CASES if n != "jax_ad_psgd"])
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


def test_four_ranks_match_the_jax_four_device_mesh(runs):
    """The JAX package lays its learner axis over 4 devices, one learner
    each; the port over 4 ranks, from the same init."""
    from repro_torch.params import from_jax_state

    jax_res = runs["jax"]
    assert jax_res["devices"] == 4
    assert "'data'" in jax_res["sharding"], jax_res["sharding"]
    state, metrics = runs["got"][4]["jax"]
    for k, (g, want) in enumerate(zip(metrics, jax_res["losses"])):
        assert abs(g["loss"] - want) <= TOL * abs(want), (k, g, want)
    want = from_jax_state({"params": jax_res["params"]})["params"]
    for (path, x), (_, y) in zip(_leaves(state["params"]), _leaves(want)):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        err = float((x.float() - y.float()).abs().max()) / (
            float(y.float().abs().max()) + 1e-12)
        assert err <= TOL, (path, err)
    # and the port's own start was the JAX init, cut into blocks
    init = from_jax_state(runs["jax_init"])
    assert init["params"]["softmax_w"].shape[0] == 4


def test_cli_at_two_ranks_prints_the_one_process_losses(runs):
    state, text = runs["got"][2]["cli"]
    want_state, want_text = runs["cli"]
    assert _loss_lines(text) == _loss_lines(want_text)
    assert any(line.startswith("final loss") for line in text.splitlines())
    assert "world: 2 ranks over gloo" in text
    _assert_same(state, want_state)


def test_torchrun_cli_at_two_ranks_prints_the_one_process_losses(runs):
    """The CLI under ``torchrun``: ``multihost.initialize`` from the
    launcher's environment (a tcp rendezvous), rank 0 printing W = 1's
    loss lines."""
    text = runs["torchrun"]
    assert "world: 2 ranks over gloo, 4 learners (2 a rank)" in text, text
    assert _loss_lines(text) == _loss_lines(runs["cli"][1]), text


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
    uninterrupted = runs["cli"][0]
    resumed = (runs["got"][2]["resumed"] if saved_at == 1
               else runs["resumed_w1"])
    _assert_same(resumed, uninterrupted)
