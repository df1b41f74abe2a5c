"""emloco_tpu_torch's data parallelism (parallel/mesh.py) on the CPU: the
placement against the JAX package's shard_env_axis, and R-rank runs over
gloo against the one-rank runs, at tests/test_parallel.py's sizes (16
envs, horizon 4, 2 minibatches).

The R-rank runs are the one-rank computation (every draw over the split
axis made whole; sums reduced over the ranks), so they are held to the JAX
package's own tolerances for its sharded epoch: metrics within 2e-3,
parameters within 2e-4 (test_parallel.py). Two steps at the configs' rates
move a parameter by less than that, so the updates themselves are held
too (`_updates_close`): Adam's first moment, which is linear in the reduced
gradients, tensor by tensor, and the parameters' change over all tensors.
An element's change is not compared: Adam's first step is lr·sign(g), and
elements whose gradient is rounding noise (an attention key's bias, whose
exact gradient is 0) change by ±lr in either run. The agent's ranks step
their envs at 4 and not 16 a call, and the engine's CPU reductions round
differently at those sizes, so its rollouts, and with them its gradients,
differ by up to 2% (held within 5e-2); the predictor's ranks see the
one-rank rows exactly (1e-4). A gradient clip hides a fault in the
gradients' scale and a clip not reached hides a fault in the clip, so
each side is run under a clip its gradients reach and under one they do
not.

All the ranks are one `cli.run.launch` of `rank_worker`, spawned once for
the file with a timeout (a hung collective fails the tests): the TCP
coordinator on two ranks, then a file store under tmp_path for the epoch,
the predictor fits and the entry point's train-policy, then one rank that
fails on purpose while the others wait for it. Each rank runs at one
thread and imports this file, so the JAX package is imported only inside
the placement test.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from emloco_tpu_torch.cli import run as cli
from emloco_tpu_torch.learning.amp_agent import AMPConfig, ClipAdam
from emloco_tpu_torch.parallel import mesh as pmesh
from emloco_tpu_torch.prediction.data import SyntheticScenes
from emloco_tpu_torch.prediction.model import TransMotionConfig
from emloco_tpu_torch.prediction.train import (PredictorTrainer,
                                               PredictTrainConfig)
from emloco_tpu_torch.rollout import build_train_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
N = 16
AMP = AMPConfig(horizon=4, num_minibatches=2, mini_epochs=1,
                amp_batch_size=16, amp_replay_size=64)
ENV = dict(sensor_res=8, episode_length=24, num_amp_obs_steps=3)
METRIC_TOL = 2e-3
PARAM_TOL = 2e-4
# Adam's first moment relative to the one-rank run's, tensor by tensor (to
# the tensor's norm, floored at MOMENT_FLOOR times the largest tensor's), by
# the key's first 4 characters; the parameters' change over all tensors
MOMENT_REL = {"": 5e-2, "clip": 5e-2, "pred": 1e-4}
MOMENT_FLOOR = 1e-3
STEP_REL = 1e-1
# the agent's update once more under this gradient clip, and the
# predictor's fits (dropout rate, gradient clip): the configs' clips (50 and
# 1) are not reached by the agent's gradients and are by the predictor's, so
# each side runs with a clip and without
CLIP_NORM = 1e-3
PRED_FITS = {0.0: float("inf"), 0.1: 1.0}
# the predictor's rate in those fits: an element whose gradient is rounding
# noise moves by ±lr a step either way, 4·lr over the fit's 2 steps, which
# stays inside PARAM_TOL
PRED_LR = 4e-5
SPAWN_TIMEOUT = 240
FAILURE = "this rank fails on purpose"
# the entry point's train-policy at the epoch's sizes
CLI_ARGV = ["train-policy", "--device", "cpu", "--mesh", str(RANKS), *(
    f"{k}={v}" for k, v in dict(
        **{f"env.{k}": v for k, v in ENV.items()}, **{
            "env.num_envs": N, "amp.horizon": 4, "amp.num_minibatches": 2,
            "amp.mini_epochs": 1, "amp.amp_batch_size": 16,
            "amp.amp_replay_size": 64, "terrain.num_tiles": 2,
            "terrain.map_length": 6.0, "epochs": 1}).items())]


def rank_worker(rank, world, argv, url, threads):
    """One rank of the 4-rank run (`cli.launch`'s target; argv: the output
    directory, a free port, then the entry point's argv). Its results go to
    rank<r>.npz, the entry point's lines to stdout."""
    import torch.distributed as dist
    out, port, cli_argv = argv[0], argv[1], argv[2:]
    torch.set_num_threads(threads)
    res = {}
    if rank < 2:
        # distributed_init's TCP coordinator, two processes
        pmesh.distributed_init(f"localhost:{port}", 2, rank)
        m = pmesh.make_mesh(2)
        res["tcp.rank_size"] = np.array([m.rank, m.size])
        res["tcp.gather"] = pmesh.gather(
            torch.tensor([rank + 1.0, 10.0 * rank]), m).numpy()
        res["tcp.sum"] = pmesh.all_reduce_sum(torch.tensor([rank + 1.0]),
                                              m).numpy()
        pmesh.barrier(m)
        dist.destroy_process_group()
    pmesh.distributed_init(f"file://{out}/store", world, rank, "gloo")
    res.update(agent_epoch(pmesh.make_mesh(world, "env")))
    res.update(predictor_fits(pmesh.make_mesh(world, "batch")))
    np.savez(f"{out}/rank{rank}.npz", **res)
    cli.run_rank([*cli_argv, f"out_dir={out}/cli"])
    pmesh.barrier(pmesh.make_mesh(world))
    dist.destroy_process_group()
    # the last rank fails while the others wait for it in a rendezvous that
    # never completes: launch must stop them and exit non-zero
    if rank == world - 1:
        raise RuntimeError(FAILURE)
    pmesh.distributed_init(f"file://{out}/store2", world, rank, "gloo")


def agent_epoch(mesh=None):
    """The reset state's per-env rows, and one epoch's metrics, the
    parameters before and after it and Adam's first moments, flattened to
    numpy; also ("clip." keys) the epoch's update from the same pools
    under a gradient clip at CLIP_NORM, which every minibatch reaches."""
    agent, ts0 = build_train_bench(N, "cpu", 0, AMP, mesh=mesh, **ENV)
    out = {"reset." + k: v for k, v in _env_rows(ts0.env_state).items()}
    out.update({f"{pre}p0.{k}": v.numpy().copy()
                for k, v in ts0.params.items() for pre in ("", "clip.")})
    # train_epoch, with the update made twice
    ts, batch, last_obs = agent.rollout(ts0)
    ts, pools = agent.prepare(ts, batch, last_obs)
    before = ts.rng.get_state()
    tx, agent.tx = agent.tx, ClipAdam(CLIP_NORM, AMP.lr)
    clipped, _ = agent.update(ts, pools)
    agent.tx = tx
    ts.rng.set_state(before)
    ts, metrics = agent.update(ts, pools)
    pmesh.check_lockstep(agent.mesh, agent_rng=ts.rng,
                         env_rng=ts.env_state.rng, params=ts.params)
    out.update({"metric." + k: v.item() for k, v in metrics.items()})
    out.update(_trained("", ts))
    out.update(_trained("clip.", clipped))
    return out


def _trained(prefix, ts):
    out = {f"{prefix}param.{k}": v.numpy() for k, v in ts.params.items()}
    out.update({f"{prefix}mu.{k}": v.numpy()
                for k, v in ts.opt_state.mu.items()})
    return out


def _env_rows(state):
    return {f"physics.{k}": getattr(state.physics, k).numpy()
            for k in ("root_pos", "u", "body_x")} | {
        k: getattr(state, k).numpy()
        for k in ("traj_verts", "progress", "amp_obs_hist", "dr_scales")}


def predictor_fits(mesh=None):
    """2-step fits of a narrow TransMotion on batches of 8 synthetic scenes
    (PRED_FITS: the dropout rate, the gradient clip): each one's loss, its
    parameters before and after and Adam's first moment."""
    out = {}
    for rate, clip in PRED_FITS.items():
        name = f"pred{rate}"
        mcfg = TransMotionConfig(nhid=16, nhead=2, dim_ff=32,
                                 nlayers_local=2, nlayers_global=1, nmode=3,
                                 dropout=rate)
        trainer = PredictorTrainer(
            mcfg, PredictTrainConfig(grad_clip=clip, lr=PRED_LR),
            device="cpu")
        ds = SyntheticScenes(num_people=3, seed=0)
        ts = trainer.init(0, ds.batch(8))
        out.update({f"{name}.p0.{k}": v.numpy().copy()
                    for k, v in ts.params.items()})
        ts, history, _ = trainer.fit(ts, ds, epochs=1, batches_per_epoch=2,
                                     batch_size=8, mesh=mesh)
        out[f"{name}.loss"] = history[0]["traj_loss"]
        out.update(_trained(f"{name}.", ts))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One `cli.launch` of RANKS rank_workers (its exit code, stdout,
    stderr, each rank's results and directory), and the one-rank run of the
    same computations, made here while the ranks run."""
    tmp = tmp_path_factory.mktemp("mesh")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import sys; from emloco_tpu_torch.cli import run; "
            "from tests.test_torch_parallel import rank_worker; "
            f"run.launch({RANKS}, sys.argv[1:], 1, rank_worker)")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(tmp), str(port), *CLI_ARGV],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        single = {**agent_epoch(), **predictor_fits()}
        out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks still running after {SPAWN_TIMEOUT} s: a hung "
                    "collective")
    finally:
        # the launcher and every rank it spawned, if any is left
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    ranks = [dict(np.load(tmp / f"rank{r}.npz"))
             for r in range(RANKS) if (tmp / f"rank{r}.npz").exists()]
    assert len(ranks) == RANKS, f"ranks failed:\n{err[-3000:]}"
    return dict(code=proc.returncode, out=out, err=err, ranks=ranks,
                single=single, dir=tmp)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _updates_close(res, single, prefix):
    """The R-rank run's parameters within PARAM_TOL of the one-rank run's,
    its Adam first moments within MOMENT_REL and its parameters' change
    within STEP_REL of the one-rank run's."""
    mu_rel = MOMENT_REL[prefix[:4]]
    keys = [k[len(prefix) + 6:] for k in single
            if k.startswith(prefix + "param.")]
    assert keys
    top = max(np.linalg.norm(single[f"{prefix}mu.{k}"]) for k in keys)
    step_err = step = 0.0
    for k in keys:
        p0 = single[f"{prefix}p0.{k}"]
        np.testing.assert_array_equal(res[f"{prefix}p0.{k}"], p0)
        p1, pr = single[f"{prefix}param.{k}"], res[f"{prefix}param.{k}"]
        assert np.abs(pr - p1).max() < PARAM_TOL, k
        m1, mr = single[f"{prefix}mu.{k}"], res[f"{prefix}mu.{k}"]
        err = np.linalg.norm(mr - m1)
        assert err <= mu_rel * max(np.linalg.norm(m1), MOMENT_FLOOR * top), \
            (k, err, np.linalg.norm(m1))
        step_err += np.sum((pr - p1) ** 2)
        step += np.sum((p1 - p0) ** 2)
    assert step > 0.0
    assert np.sqrt(step_err / step) <= STEP_REL, np.sqrt(step_err / step)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def _jax_tree(ts):
    """The port's TrainState as the JAX package's TrainState (its arrays as
    jnp arrays, the generators as PRNG keys, the Adam state as a dict)."""
    import jax
    import jax.numpy as jnp
    from emloco_tpu.envs.pedestrian_terrain import EnvState as JEnvState
    from emloco_tpu.learning.amp_agent import TrainState as JTrainState
    from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
    from emloco_tpu.physics.reduced import PhysicsState as JPhysicsState
    key = jax.random.PRNGKey(0)

    def arr(v):
        return None if v is None else jnp.asarray(v.numpy())

    es = ts.env_state
    jes = JEnvState(
        physics=JPhysicsState(**{k: arr(getattr(es.physics, k))
                                 for k in JPhysicsState.__dataclass_fields__}),
        **{k: key if k == "rng" else arr(getattr(es, k))
           for k in JEnvState.__dataclass_fields__ if k != "physics"})

    def norm(n):
        return JRunningNorm(mean=arr(n.mean), var=arr(n.var),
                            count=arr(n.count))

    return JTrainState(
        params={k: arr(v) for k, v in ts.params.items()},
        opt_state={"count": arr(ts.opt_state.count),
                   "mu": {k: arr(v) for k, v in ts.opt_state.mu.items()},
                   "nu": {k: arr(v) for k, v in ts.opt_state.nu.items()}},
        obs_norm=norm(ts.obs_norm), amp_norm=norm(ts.amp_norm),
        value_norm=norm(ts.value_norm), env_state=jes,
        replay_amp=arr(ts.replay_amp), replay_ptr=jnp.asarray(0),
        replay_filled=jnp.asarray(0), key=key, epoch=jnp.asarray(0),
        task_reward_w=arr(ts.task_reward_w),
        disc_reward_w=arr(ts.disc_reward_w))


def _port_decisions(tree, out, names=()):
    """{dotted field path: sharded?} of the port's placement (a sharded
    leaf is a new tensor, a replicated one the input itself)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "__dataclass_fields__"):
        items = ((k, getattr(tree, k)) for k in tree.__dataclass_fields__)
    else:
        return {".".join(names): out is not tree}
    res = {}
    for k, v in items:
        o = out[k] if isinstance(tree, dict) else getattr(out, k)
        res.update(_port_decisions(v, o, names + (str(k),)))
    return res


def _assert_same_leaves(a, b, names=()):
    """Two trees of the same fields, leaf for leaf bit-equal (a generator
    by its state)."""
    what = ".".join(names)
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same_leaves(getattr(a, f.name), getattr(b, f.name),
                                names + (f.name,))
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), what
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(a, b), what
    else:
        assert a is None and b is None, what


def _jax_decisions(tree):
    import jax
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        res[".".join(str(n) for n in names)] = (
            leaf.sharding.spec == jax.sharding.PartitionSpec("env"))
    return res


@pytest.mark.parametrize("collide", [False, True])
def test_shard_env_axis_matches_jax(collide):
    """Field by field, the port's placement is the JAX package's on its 8
    virtual CPU devices, and a rank's env starts from exactly that part of
    the one-rank state; with `collide` the motion count and the replay
    ring equal num_envs (hard-negative tables and the ring stay
    replicated)."""
    kw = dict(ENV)
    amp = AMP
    if collide:
        amp = dataclasses.replace(AMP, amp_batch_size=8, amp_replay_size=N)
        kw.update(hard_negative=True)
    agent, ts = build_train_bench(N, "cpu", 0, amp, **kw)
    mesh = pmesh.Mesh(5, 8, "cpu")
    _, rank_ts = build_train_bench(N, "cpu", 0, amp, mesh=mesh, **kw)
    _assert_same_leaves(rank_ts.env_state,
                        pmesh.shard_env_axis(ts, mesh, N).env_state)
    if collide:
        # a 16-motion library: its per-motion tables lead with num_envs
        env = agent.env
        M = env.motion_lib.num_motions
        ts = ts.replace(env_state=ts.env_state.replace(**{
            k: getattr(ts.env_state, k).repeat(N // M)[:N]
            for k in ("motion_weights", "motion_sampled", "motion_term",
                      "motion_succ")}))
        assert ts.replay_amp.shape[0] == N
        assert ts.env_state.motion_weights.shape[0] == N
    from emloco_tpu.parallel import mesh as jmesh
    want = _jax_decisions(jmesh.shard_env_axis(_jax_tree(ts),
                                               jmesh.make_mesh(8), N))
    for r in (0, 5):
        out = pmesh.shard_env_axis(ts, pmesh.Mesh(r, 8, "cpu"), N)
        got = _port_decisions(ts, out)
        env_paths = {k for k in want if k.startswith("env_state.")}
        assert env_paths <= got.keys()
        for k in env_paths | {"replay_amp", "obs_norm.mean",
                              "task_reward_w"}:
            assert got[k] == want[k], k
        assert not any(v for k, v in got.items()
                       if not k.startswith("env_state."))
        assert out.env_state.physics.root_pos.shape[0] == N // 8
        np.testing.assert_array_equal(
            out.env_state.physics.root_pos.numpy(),
            ts.env_state.physics.root_pos[r * 2:(r + 1) * 2].numpy())
        assert out.replay_amp is ts.replay_amp
    assert want["env_state.physics.root_pos"]
    assert not want["replay_amp"]
    if collide:
        assert not want["env_state.motion_weights"]


def test_non_divisible_raises():
    """20 envs over 8 ranks: shard_env_axis, the env and a rank's block
    refuse, naming the numbers; crowd shards must fall on group
    boundaries."""
    agent, ts = build_train_bench(20, "cpu", 0, AMP, **ENV)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_env_axis(ts, pmesh.Mesh(0, 8, "cpu"), 20)
    with pytest.raises(ValueError, match="not divisible"):
        build_train_bench(20, "cpu", 0, AMP, mesh=pmesh.Mesh(0, 8, "cpu"),
                          **ENV)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.Mesh(0, 4, "cpu").block(10)
    with pytest.raises(ValueError, match=r"num_envs=32 / 4 ranks = 8 envs "
                                         r"a rank, group_size=16"):
        build_train_bench(32, "cpu", 0, AMP, mesh=pmesh.Mesh(0, 4, "cpu"),
                          group_obs=True, group_size=16, **ENV)
    with pytest.raises(ValueError, match="leading dim"):
        pmesh.shard_env_axis(ts.replace(env_state=ts.env_state.replace(
            progress=ts.env_state.progress[:4])), pmesh.Mesh(0, 4, "cpu"),
            20)


def test_rank_without_minibatch_rows():
    """A rank that holds none of a minibatch's rows adds zero terms and
    zero gradients (the minibatch's other rows are on other ranks)."""
    agent, ts = build_train_bench(N, "cpu", 0, AMP,
                                  mesh=pmesh.Mesh(1, RANKS, "cpu"), **ENV)
    env = agent.env
    mb = dict(obs_n=torch.zeros((0, env.obs_dim)),
              flip_obs_n=torch.zeros((0, env.obs_dim)),
              action=torch.zeros((0, env.cfg.num_actions)),
              logp=torch.zeros((0,)), adv=torch.zeros((0,)),
              ret_n=torch.zeros((0,)), ret_01=torch.zeros((0,)),
              amp_n=torch.zeros((0, agent.amp_dim)))
    split = agent._rank_rows(np.array([0, 1, 2, 3]), 4, 8)[2]
    assert split == dataclasses.replace(split, rollout=0)
    total, terms, grads = agent._loss_and_grads(
        ts.params, mb, torch.zeros((4, agent.amp_dim)),
        torch.zeros((2, agent.amp_dim)), None, split)
    for k in ("a_loss", "c_loss", "b_loss", "tv_loss"):
        assert terms[k].item() == 0.0, k
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert not split.param_terms


# --------------------------------------------------------------------------
# the 4-rank runs
# --------------------------------------------------------------------------

def test_four_rank_reset_is_the_one_rank_rows(run):
    """Each rank's reset state is its block of the one-rank reset, bit for
    bit (the whole env axis's reset, shard_env_axis). The states after the
    epoch are not compared: the engine's
    CPU reductions round differently at 4 and 16 envs (1e-6 to 2e-4 of u
    after one step) and the exp-map snap (ROADMAP §C) grows that."""
    single = run["single"]
    for r, res in enumerate(run["ranks"]):
        rows = slice(r * N // RANKS, (r + 1) * N // RANKS)
        for k in (k for k in single if k.startswith("reset.")):
            np.testing.assert_array_equal(res[k], single[k][rows], k)


def test_four_rank_epoch_matches_one_rank(run):
    single, ranks = run["single"], run["ranks"]
    for res in ranks:
        for k in (k for k in single if k.startswith("metric.")):
            _close(res[k], single[k], METRIC_TOL, k)
        for prefix in ("", "clip."):
            _updates_close(res, single, prefix)
        for k in (k for k in single
                  if k.startswith(("param.", "mu.", "clip."))):
            # replicated state: the ranks hold the same bits
            np.testing.assert_array_equal(res[k], ranks[0][k])
        assert res["metric.nonfinite_grad"] == 0.0


@pytest.mark.parametrize("rate", list(PRED_FITS))
def test_four_rank_predictor_fit_matches_one_rank(run, rate):
    single, ranks = run["single"], run["ranks"]
    fit = f"pred{rate}"
    for res in ranks:
        _close(res[f"{fit}.loss"], single[f"{fit}.loss"], METRIC_TOL,
               "loss")
        _updates_close(res, single, f"{fit}.")
        for k in (k for k in single
                  if k.startswith((f"{fit}.param.", f"{fit}.mu."))):
            np.testing.assert_array_equal(res[k], ranks[0][k])


def test_distributed_init_over_tcp(run):
    """Two ranks joined through distributed_init's TCP coordinator: the
    mesh reports rank and size, and gather and the sums agree; for one
    process distributed_init is a no-op."""
    for r, res in enumerate(run["ranks"][:2]):
        assert res["tcp.rank_size"].tolist() == [r, 2]
        assert res["tcp.gather"].tolist() == [[1.0, 0.0], [2.0, 10.0]]
        assert res["tcp.sum"].tolist() == [3.0]
    pmesh.distributed_init(None, 1, 0)          # one process: a no-op
    m = pmesh.make_mesh()
    assert (m.rank, m.size) == (0, 1)


def test_cli_mesh_train_policy(run):
    """The entry point's train-policy on the 4 gloo ranks at 16 envs: each
    rank reports gloo and the device map first and its launch counts last;
    rank 0 writes the checkpoint and the metrics row, which names the
    mesh; the ranks end with the same parameters."""
    lines = [json.loads(x) for x in run["out"].splitlines()
             if x.startswith("{")]
    firsts = [x for x in lines if "backend" in x]
    assert sorted(x["rank"] for x in firsts) == list(range(RANKS))
    assert all(x["backend"] == "gloo" and x["devices"] == ["cpu"] * RANKS
               for x in firsts)
    lasts = [x for x in lines if "launches" in x]
    assert sorted(x["rank"] for x in lasts) == list(range(RANKS))
    assert len({x["params_sha256"] for x in lasts}) == 1
    out = run["dir"] / "cli"
    assert sorted(os.listdir(out)) == [
        "policy.metrics.jsonl", "policy_00000000.ckpt", "tb"]
    with open(out / "policy.metrics.jsonl") as f:
        (row,) = [json.loads(x) for x in f]
    assert row["mesh_backend"] == "gloo"
    assert row["mesh_devices"] == " ".join(["cpu"] * RANKS)
    assert all(np.isfinite(v) for v in row.values()
               if isinstance(v, float))


def test_failing_rank_stops_the_launch(run):
    """The last rank raises while the others wait for it: launch stops
    them (the run ends inside its timeout) and exits non-zero."""
    assert run["code"] != 0
    assert FAILURE in run["err"]
    assert f"--mesh {RANKS}: rank" in run["err"]


@pytest.mark.parametrize("argv", [
    ["eval-policy", "--mesh", "2"], ["train-valuenet", "--mesh", "4"],
    ["train-policy", "--mesh", "2", "--profile"]])
def test_cli_mesh_refused_elsewhere(argv, tmp_path):
    with pytest.raises(SystemExit, match="--mesh"):
        cli.main([*argv, "--device", "cpu", f"out_dir={tmp_path}"])
    assert not os.listdir(tmp_path)
