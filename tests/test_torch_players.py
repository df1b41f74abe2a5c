"""The port's evaluation players against emloco_tpu/learning/players.py on
the CPU, at 4 envs on flat terrain (the world of
tests/test_tuning_visualize.py::test_policy_eval_artifacts).

`rollout_with_rewards` runs 6 deterministic control steps (one substep
each) of the same
policy from the same state (the port's fresh params, norms and reset env
state carried to JAX): the frames, the reward terms and the trajectory within 2⁻⁸ of
their magnitude, the tolerance of the earlier env tests (a bfloat16
Jacobian entry may round the other way). The JAX rollout compiles at XLA
optimization level 0. Then the artifacts: `save_eval_artifacts`' scatter,
histogram and GIF, `animate_optimization` and `plot_heightmap`, and the
entry points `eval_policy --grid` and `optimize_traj --gif` on the CPU.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from emloco_tpu.envs import EnvConfig as JEnvConfig
from emloco_tpu.envs import EnvState as JEnvState
from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.learning import players as jplayers
from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import PhysicsState as JPhysicsState
from emloco_tpu.physics import flat_terrain as jflat
from emloco_tpu_torch import convert, eval_policy, optimize_traj
from emloco_tpu_torch.analysis import animate_optimization
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.kinematics.visualization import plot_heightmap
from emloco_tpu_torch.learning import ValuePoseNet, players
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.learning.value_train import (LocoValTrainer,
                                                   ValueTrainConfig)
from emloco_tpu_torch.physics import EngineConfig, flat_terrain
from emloco_tpu_torch.utils.checkpoint import save_valuenet

SMALL = dict(num_envs=4, sensor_res=8, episode_length=12,
             num_amp_obs_steps=3)
# one substep a control step (both packages) shortens the JAX rollout's
# compile and the CPU rollouts; the control step runs the same code
ONE_SUBSTEP = dict(n_substeps=1)
AMP = dict(horizon=4, num_minibatches=2, mini_epochs=1, amp_batch_size=8,
           amp_replay_size=32)
STEPS = 6
BF16 = 2.0 ** -8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CLI_SMALL = ["amp.amp_replay_size=8", "env.sensor_res=8",
             "env.num_amp_obs_steps=3", "env.episode_length=16",
             "engine.n_substeps=1"]


class FastJit:
    """jax.jit whose first call compiles at XLA optimization level 0."""

    def __init__(self, fn):
        self.fn, self.compiled = jax.jit(fn), None

    def __call__(self, *args):
        if self.compiled is None:
            self.compiled = self.fn.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        return self.compiled(*args)


def jx(x):
    return None if x is None else jnp.asarray(x.numpy())


def to_jax(obj, cls, **fixed):
    """A port dataclass of tensors as the JAX package's `cls`, field by
    field."""
    return cls(**{f.name: jx(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.name not in fixed},
               **fixed)


@pytest.fixture(scope="module")
def world():
    """The port's agent and its fresh state (params, norms, reset env), and
    the JAX agent on the same terrain and motions with that state carried
    across by field name (JAX's own init and motion build compile for
    tens of seconds)."""
    env = PedestrianTerrainEnv(
        EnvConfig(**SMALL, engine=EngineConfig(**ONE_SUBSTEP)),
        flat_terrain(extent=20.0, cell=0.1,
                                         device="cpu"),
        tml.synthetic_walk_motions(speeds=(1.0,), duration=1.5,
                                   device="cpu"), device="cpu")
    agent = AMPAgent(env, AMPConfig(**AMP))
    ts = agent.init(0)
    jlib = to_jax(env.motion_lib, jml.MotionLib)
    jenv = JEnv(JEnvConfig(**SMALL, engine=JEngineConfig(**ONE_SUBSTEP)),
                jflat(extent=20.0, cell=0.1), jlib)
    jagent = JAgent(jenv, JAMPConfig(**AMP))
    st = ts.env_state
    jts = types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, convert.agent_params(ts.params)),
        obs_norm=to_jax(ts.obs_norm, JRunningNorm),
        env_state=to_jax(st, JEnvState, rng=jax.random.PRNGKey(0),
                         physics=to_jax(st.physics, JPhysicsState)))
    return jagent, jts, agent, ts


def close(got, want):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16 * max(np.abs(want).max(), 1e-6)


def test_rollout_with_rewards_matches_jax(world, monkeypatch):
    jagent, jts, agent, ts = world
    monkeypatch.setattr(jplayers, "jax", types.SimpleNamespace(
        jit=FastJit, random=jax.random, lax=jax.lax))
    jframes, jrew, jtraj = jplayers.rollout_with_rewards(jagent, jts, STEPS)
    frames, rew, traj = players.rollout_with_rewards(agent, ts, STEPS)
    assert frames.shape == (STEPS, 24, 3)
    close(frames, jframes)
    assert sorted(rew) == sorted(jrew) == ["loc", "power", "total"]
    for k in rew:
        close(rew[k], jrew[k])
    close(traj, jtraj)
    assert np.isfinite(frames).all()


def test_eval_artifacts_written(world, tmp_path):
    _, _, agent, ts = world
    trainer = LocoValTrainer(agent, ValuePoseNet(device="cpu"),
                             ValueTrainConfig(horizon=14, step_to_pred=8))
    vts = trainer.init(ts, 1)
    vts, arts = players.save_eval_artifacts(trainer, vts, str(tmp_path),
                                            name="test", num_epochs=1,
                                            gif_steps=6)
    for k in ("gif", "scatter", "hist"):
        assert os.path.getsize(arts[k]) > 0, k
    assert np.isfinite(arts["mse"])


def test_optimization_gif_and_heightmap(tmp_path):
    rng = np.random.default_rng(0)
    snaps = np.cumsum(rng.normal(size=(11, 2, 13, 2)), 2).astype(np.float32)
    values = rng.uniform(size=(11, 2)).astype(np.float32)
    out = animate_optimization(torch.as_tensor(snaps), values,
                               str(tmp_path / "opt.gif"), stride=5)
    assert os.path.getsize(out) > 0
    out = plot_heightmap(rng.normal(size=(8, 8)), str(tmp_path / "h.png"))
    assert os.path.getsize(out) > 0


def test_eval_policy_grid_on_cpu(capsys):
    lines = eval_policy.main(["--device", "cpu", "--num-envs", "8",
                              "--games", "1", "--grid", *CLI_SMALL])
    printed = [json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    assert [ln["condition"] for ln in lines] == [
        c for c, _ in eval_policy.GRID]
    for ln in lines:
        assert ln["latched"] > 0 and np.isfinite(ln["mse"]), ln
        assert np.isfinite(ln["corr"]) and ln["device"] == "cpu"


def test_optimize_traj_gif_on_cpu(tmp_path, capsys):
    vnet = ValuePoseNet(use_pose=False, use_vel=True,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    path = str(tmp_path / "valuenet.ckpt")
    save_valuenet(path, dict(vnet.named_parameters()),
                  dict(use_pose=False, use_vel=True))
    optimize_traj.main(["--valuenet", path, "--device", "cpu", "--steps",
                        "10", "--batch-size", "3", "--gif", "--out",
                        str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.getsize(line["gif"]) > 0
    assert np.isfinite(line["value_after"])
