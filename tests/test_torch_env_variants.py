"""The getup and hand-task envs and the getup reward schedule against the
JAX package's.

4 envs, sensor_res 4, 3 AMP steps. JAX's draws cannot be reproduced in
torch, so each draw of these envs is a function of its own and the tests
feed them JAX's values:
  - the fall bank: JAX's root-orientation normals, spawn points and
    actions (its key splits from PRNGKey(1234)) through the port's
    `_fall_states`, against JAX's bank after 3 control steps at one
    substep with self-contact and mesh colliders (the chaotic full bank is
    held on the port alone by `chip_smoke.py`'s getup phase);
  - the getup auto-reset: JAX's base auto-reset state and its two coins
    (the key splits its `_auto_reset` makes) through the port's pure
    `_getup_reset`;
  - the hand targets: JAX's fresh targets through `hand_target_draw`.
The state is the port's reset state carried to JAX by field name.
Tolerances: the bank one bf16 ulp, 2⁻⁸, of each quantity's largest
magnitude (bf16 Jacobian rows) and 1e-4 m on positions; observations and
the reward 1e-5 of the largest magnitude (float32 work in another order);
the auto-reset 1e-5 (the AMP window of a fall state is rebuilt from
float32 kinematics); selections and counters exact.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import getup as jgetup
from emloco_tpu.envs import hand_task as jhand
from emloco_tpu.envs.pedestrian_terrain import PedestrianTerrainEnv as JEnv
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import PhysicsState as JPhysicsState
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import getup, hand_task
from emloco_tpu_torch.envs.pedestrian_terrain import EnvConfig
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.physics import EngineConfig

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=4, episode_length=48,
             num_amp_obs_steps=3)
ENGINE = dict(n_substeps=1, self_contact=True, mesh_contacts=True)
GETUP = dict(fall_gen_steps=3, fall_init_prob=0.5,
             recovery_episode_prob=0.5)
BF16, OBS_REL = 2.0 ** -8, 1e-5


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def jx(t):
    return None if t is None else jnp.asarray(t.numpy())


def to_jax_state(ts, cls, key):
    """A port env state as the JAX package's `cls`, drawing from `key`."""
    phys = JPhysicsState(**{f.name: jx(getattr(ts.physics, f.name))
                            for f in dataclasses.fields(ts.physics)})
    rest = {f.name: jx(getattr(ts, f.name)) for f in dataclasses.fields(ts)
            if f.name not in ("physics", "rng")}
    return cls(physics=phys, rng=key, **rest)


def to_port_state(js, cls, gen):
    """A JAX env state as the port's `cls`, drawing from `gen`."""
    phys = convert.physics_state(jax.tree.map(np.asarray, js.physics), "cpu")
    rest = {f.name: convert.tensor(getattr(js, f.name, None), "cpu")
            for f in dataclasses.fields(cls)
            if f.name not in ("physics", "rng")}
    return cls(physics=phys, rng=gen, **rest)


@pytest.fixture(scope="module")
def world():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    hf = convert.heightfield(jax.tree.map(np.asarray, jterr), "cpu")
    lib = tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                     device="cpu")
    jlib = jml.MotionLib(**{f.name: jx(getattr(lib, f.name))
                            for f in dataclasses.fields(lib)})
    jcfg = jgetup.GetupEnvConfig(**SMALL, **GETUP,
                                 engine=JEngineConfig(**ENGINE))
    cfg = getup.GetupEnvConfig(**SMALL, **GETUP, engine=EngineConfig(**ENGINE))
    jenv = jgetup.PedestrianTerrainGetupEnv(jcfg, jterr, jlib)
    env = getup.PedestrianTerrainGetupEnv(cfg, hf, lib, device="cpu")
    hcfg = EnvConfig(**SMALL, engine=EngineConfig(n_substeps=1))
    jhcfg = jgetup.EnvConfig(**SMALL, engine=JEngineConfig(n_substeps=1))
    return dict(jenv=jenv, env=env, jterr=jterr, hf=hf, lib=lib, jlib=jlib,
                henv=hand_task.PedestrianTerrainHandEnv(hcfg, hf, lib,
                                                        device="cpu"),
                jhenv=jhand.PedestrianTerrainHandEnv(jhcfg, jterr, jlib))


def test_fall_bank_matches_jax_from_fed_draws(world):
    jenv, env = world["jenv"], world["env"]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1234), 3)
    draws = (jax.random.normal(k1, (N, 4)), jenv._sample_spawn(k2, N),
             jax.random.uniform(k3, (N, 23, 3), minval=-0.5, maxval=0.5))
    bank = env._fall_states(*(torch.as_tensor(np.array(d)) for d in draws))
    jb = jenv.fall_bank
    assert env.cfg.fall_gen_steps // env.cfg.engine.n_substeps == 3
    for f in ("root_pos", "body_x"):
        np.testing.assert_allclose(getattr(bank, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=1e-4)
    for f in ("root_rot", "joint_rot", "body_q", "u", "body_v", "body_w",
              "contact_force"):
        rel_close(getattr(bank, f), getattr(jb, f), BF16)
    # the drop lands: the falling humanoids touch the ground
    assert float(bank.contact_force.norm(dim=-1).sum()) > 100.0
    # the port's own draws: the shapes and ranges of JAX's
    rot, xy, act = getup.fall_bank_draw(env, torch.Generator().manual_seed(0),
                                        N)
    assert rot.shape == (N, 4) and xy.shape == (N, 2)
    assert act.shape == (N, 23, 3) and float(act.abs().max()) <= 0.5


@pytest.fixture(scope="module")
def getup_states(world):
    """The port's reset state with set probabilities and counters, and the
    JAX state carrying it."""
    env = world["env"]
    ts = env.reset(torch.Generator().manual_seed(3))
    ts = ts.replace(recovery_counter=torch.tensor([3, 0, 5, 1],
                                                  dtype=torch.int32))
    js = to_jax_state(ts, jgetup.GetupEnvState, jax.random.PRNGKey(9))
    return ts, js


def test_getup_reset_and_schedules_match_jax(world, getup_states):
    jenv, env = world["jenv"], world["env"]
    ts = env.reset(torch.Generator().manual_seed(3))
    assert isinstance(ts, getup.GetupEnvState)
    assert ts.recovery_counter.dtype == torch.int32
    assert not bool(ts.recovery_counter.any())
    assert float(ts.fall_init_prob) == 0.5
    _, js = getup_states
    for epoch, upd in ((3, 4), (4, 4), (5, 4), (0, None)):
        a = env.update_getup_schedule(ts, epoch, upd)
        b = jenv.update_getup_schedule(js, epoch, upd)
        for f in ("fall_init_prob", "recovery_episode_prob"):
            assert float(getattr(a, f)) == float(getattr(b, f)), (epoch, f)
    np.testing.assert_array_equal(
        env._termination_allowed(getup_states[0]).numpy(),
        np.asarray(jenv._termination_allowed(js)))


def test_getup_auto_reset_matches_jax(world, getup_states):
    """The fall-bank swap (moved to the fresh spawn), the AMP window and
    LocoVal inputs of the fall states and the recovery counters, from
    JAX's base auto-reset state and coins."""
    jenv, env = world["jenv"], world["env"]
    ts, js = getup_states
    env.fall_bank = convert.physics_state(
        jax.tree.map(np.asarray, jenv.fall_bank), "cpu")
    done = np.array([True, False, True, True])
    key, k_fall, k_rec = jax.random.split(js.rng, 3)
    new_j = JEnv._auto_reset(jenv, js.replace(rng=key), jnp.asarray(done))
    want = jenv._auto_reset(js, jnp.asarray(done))
    u_fall = jax.random.uniform(k_fall, (N,))
    u_rec = jax.random.uniform(k_rec, (N,))
    new_t = to_port_state(new_j, getup.GetupEnvState, ts.rng)
    got = env._getup_reset(ts, new_t, torch.as_tensor(done),
                           torch.as_tensor(np.array(u_fall)),
                           torch.as_tensor(np.array(u_rec)))
    use_fall = (np.asarray(u_fall) < 0.5) & done
    assert use_fall.any() and (done & ~use_fall).any()
    np.testing.assert_array_equal(got.recovery_counter.numpy(),
                                  np.asarray(want.recovery_counter))
    for f in dataclasses.fields(got.physics):
        rel_close(getattr(got.physics, f.name),
                  getattr(want.physics, f.name), OBS_REL)
    for f in ("amp_obs_hist", "waypoint_traj", "init_pose", "init_vel",
              "traj_verts", "progress"):
        rel_close(getattr(got, f), getattr(want, f), OBS_REL)
    # the draws: two uniforms from the env's generator
    u = getup.getup_reset_draw(torch.Generator().manual_seed(0), N, "cpu")
    assert [tuple(x.shape) for x in u] == [(N,), (N,)]


def test_termination_allowed_gates_the_step(world, getup_states):
    """An env in its recovery grace period cannot terminate early: every
    env is put 10 m from its trajectory, and only those whose counter is 0
    terminate."""
    env = world["env"]
    ts, _ = getup_states
    ph = ts.physics
    far = torch.tensor([10.0, 10.0, 0.0])
    ts = ts.replace(physics=ph.replace(root_pos=ph.root_pos + far,
                                       body_x=ph.body_x + far))
    _, out = env.step(ts, torch.zeros((N, 69)))
    np.testing.assert_array_equal(out.terminated.numpy(),
                                  ts.recovery_counter.numpy() <= 0)


@pytest.fixture(scope="module")
def hand_states(world):
    henv = world["henv"]
    ts = henv.reset(torch.Generator().manual_seed(4))
    targets = np.random.RandomState(2).rand(N, 2).astype(np.float32)
    ts = ts.replace(hand_targets=torch.as_tensor(targets))
    js = to_jax_state(ts, jhand.HandEnvState, jax.random.PRNGKey(6))
    return ts, js


def test_hand_observation_matches_jax(world, hand_states):
    """The insert of the two targets after the trajectory samples, the
    widths, and the mirror (targets swapped)."""
    henv, jhenv = world["henv"], world["jhenv"]
    ts, js = hand_states
    assert henv.obs_dim == jhenv.obs_dim == henv.cfg.obs_dim + 2
    assert henv.task_obs_dim == jhenv.task_obs_dim
    o = henv.observe(ts)
    want = jax.jit(jhenv.observe)(js)
    rel_close(o, want, OBS_REL)
    sd, S = henv.cfg.self_obs_dim, 2 * henv.cfg.num_traj_samples
    torch.testing.assert_close(o[:, sd + S:sd + S + 2], ts.hand_targets,
                               rtol=0, atol=0)
    flip = henv.observe_flipped_from(o)
    rel_close(flip, jhenv.observe_flipped_from(jnp.asarray(o.numpy())),
              OBS_REL)
    torch.testing.assert_close(flip[:, sd + S:sd + S + 2],
                               ts.hand_targets.flip(-1), rtol=0, atol=0)
    torch.testing.assert_close(flip, henv.observe_flipped(ts), rtol=0,
                               atol=2e-4)


def test_hand_reward_and_auto_reset_match_jax(world, hand_states,
                                              monkeypatch):
    henv, jhenv = world["henv"], world["jhenv"]
    ts, js = hand_states
    progress = torch.tensor([1, 5, 9, 20], dtype=torch.int32)
    pd = np.random.RandomState(3).randn(N, 23, 3).astype(np.float32) * 0.2
    r, raw = henv._reward(ts, ts.physics, progress, torch.as_tensor(pd))
    jr, jraw = jhenv._reward(js, js.physics, jnp.asarray(progress.numpy()),
                             jnp.asarray(pd))
    rel_close(r, jr, OBS_REL)
    rel_close(raw, jraw, OBS_REL)
    done = np.array([False, True, True, False])
    want = jhenv._auto_reset(js, jnp.asarray(done))
    new_j = JEnv._auto_reset(jhenv, js, jnp.asarray(done))
    fresh = jax.random.uniform(jax.random.fold_in(new_j.rng, 78), (N, 2))
    monkeypatch.setattr(hand_task, "hand_target_draw",
                        lambda gen, n, device, mesh=None: torch.as_tensor(
                            np.array(fresh)))
    got = henv._auto_reset(ts, torch.as_tensor(done))
    np.testing.assert_array_equal(got.hand_targets.numpy(),
                                  np.asarray(want.hand_targets))
    assert isinstance(got, hand_task.HandEnvState)


def test_getup_reward_schedule_matches_jax():
    """Disc reward alone up to the update epoch, the configured mix
    after."""
    class TS:
        def __init__(self, w):
            self.task_reward_w = w

        def replace(self, **kw):
            return kw

    port = types.SimpleNamespace(cfg=AMPConfig(task_reward_w=0.3,
                                               disc_reward_w=0.7))
    jself = types.SimpleNamespace(cfg=JAMPConfig(task_reward_w=0.3,
                                                 disc_reward_w=0.7))
    for epoch in (0, 9, 10, 11):
        a = AMPAgent.update_getup_reward_schedule(
            port, TS(torch.tensor(0.5)), epoch, 10)
        b = JAgent.update_getup_reward_schedule(jself, TS(None), epoch, 10)
        for k in ("task_reward_w", "disc_reward_w"):
            assert float(a[k]) == float(b[k]), (epoch, k)
