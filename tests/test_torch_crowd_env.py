"""The port's env options against emloco_tpu's PedestrianTerrainEnv: the
sensor shapes (square, "fov", "square_fov"), the velocity map, the crowd
observation of group_obs, observation and action noise, root pushes,
projectile hits and hard-negative motion sampling. 8 envs, sensor_res 8, 3
AMP steps, one engine substep (the JAX step compiles in about half the time;
the default engine's step is held in tests/test_torch_env.py).

Three worlds share one terrain, motion library, body and state:
  A — group_obs (groups of 4, spawned within 1 m) + velocity map + fan
      sensor + both noises + pushes and projectiles at interval 1 +
      hard_negative: observe, one step, the mirror, observe_with_traj and
      the hard-negative bookkeeping;
  B — the velocity map alone on the square sensor: observe and the mirror;
  C — the forward-square sensor: observe and the mirror.
The state is the port's reset state, carried to JAX by field name. JAX's
reset is stubbed inside its step (each env's fresh state is the initial
one); no env resets on the compared step, so the stub changes nothing
compared. The perturbations' draws are JAX's own, from the key splits its
step makes, fed to the port's draw functions.

Tolerances: observations 1e-5 of each quantity's largest magnitude (float32
work in the same order); the step one bf16 ulp (2^-8), as
tests/test_torch_env.py, whose docstring says why; the port's feature-space
mirror against its state-based one 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import EnvConfig as JEnvConfig
from emloco_tpu.envs import EnvState as JEnvState
from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
from emloco_tpu.envs import observations as jobs
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import PhysicsState as JPhysicsState
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.envs import pedestrian_terrain as pt
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.physics import EngineConfig

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 8
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3)
WORLDS = {
    "A": dict(group_obs=True, group_size=4, group_spawn_spread=1.0,
              velocity_map=True, sensor_shape="fov", obs_noise_std=0.1,
              action_noise_std=0.1, push_interval=1, projectile_interval=1,
              hard_negative=True),
    "B": dict(velocity_map=True),
    "C": dict(sensor_shape="square_fov"),
}
# each option of the JAX EnvConfig → the world that holds it
OPTIONS = {"obs_noise": "A", "action_noise": "A", "push": "A",
           "projectile": "A", "hard_negative": "A", "group_obs": "A",
           "velocity_map": "B", "fov": "A", "square_fov": "C"}
STEP_OPTIONS = [o for o in OPTIONS if o != "square_fov"]
# the perturbations' draw functions, by option
DRAWS = {"action_noise": "action_noise_draw", "push": "push_draw",
         "projectile": "projectile_draw", "obs_noise": "obs_noise_draw"}
BF16 = 2.0 ** -8
OBS_REL, FLIP_ATOL = 1e-5, 2e-4


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def jx(t):
    return None if t is None else jnp.asarray(t.numpy())


def to_jax_state(ts, key):
    """A port EnvState as the JAX package's, drawing from `key`."""
    phys = JPhysicsState(**{f.name: jx(getattr(ts.physics, f.name))
                            for f in dataclasses.fields(ts.physics)})
    rest = {f.name: jx(getattr(ts, f.name)) for f in dataclasses.fields(ts)
            if f.name not in ("physics", "rng")}
    return JEnvState(physics=phys, rng=key, **rest)


def cfgs(world):
    eng = dict(engine=EngineConfig(n_substeps=1))
    jeng = dict(engine=JEngineConfig(n_substeps=1))
    kw = {**SMALL, **WORLDS[world]}
    return JEnvConfig(**kw, **jeng), EnvConfig(**kw, **eng)


def jax_draws(key, obs_dim):
    """The perturbations' draws of one JAX step from its state's key, in
    the order of its splits."""
    rng, k_an = jax.random.split(key)
    draws = {"action_noise": jax.random.normal(k_an, (N, 69))}
    rng, k_push = jax.random.split(rng)
    draws["push"] = jax.random.normal(k_push, (N, 3))
    rng, k_b, k_d = jax.random.split(rng, 3)
    draws["projectile"] = (jax.random.randint(k_b, (N,), 0, 24),
                           jax.random.normal(k_d, (N, 3)))
    key_after, _, _ = jax.random.split(rng, 3)       # the auto-reset's
    draws["obs_noise"] = jax.random.normal(jax.random.fold_in(key_after, 3),
                                           (N, obs_dim))
    return {k: jax.tree.map(lambda a: torch.as_tensor(np.array(a)), v)
            for k, v in draws.items()}


@pytest.fixture(scope="module")
def run():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    hf = convert.heightfield(np_tree(jterr), "cpu")
    lib = tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                     device="cpu")
    jlib = jml.MotionLib(**{f.name: jx(getattr(lib, f.name))
                            for f in dataclasses.fields(lib)})
    out = {"jenv": {}, "env": {}}
    params = jparams = None
    for w in WORLDS:
        jcfg, cfg = cfgs(w)
        out["jenv"][w] = JEnv(jcfg, jterr, jlib, params=jparams)
        out["env"][w] = PedestrianTerrainEnv(cfg, hf, lib, params=params,
                                             device="cpu")
        jparams, params = out["jenv"][w].params, out["env"][w].params
    env, jenv = out["env"]["A"], out["jenv"]["A"]
    ts = env.reset(torch.Generator().manual_seed(4))
    js = to_jax_state(ts, jax.random.PRNGKey(5))
    out.update(ts=ts, js=js, jobs={w: jax.jit(je.observe)(js)
                                   for w, je in out["jenv"].items()})

    def stub(key, n, motion_weights=None):
        mids = jax.random.choice(key, jlib.num_motions, (n,),
                                 p=motion_weights)
        return js.physics, js.traj_verts, js.inverted, mids

    jenv._reset_states = stub
    mu = np.random.default_rng(6).normal(0, 0.3, (N, 69)).astype(np.float32)
    out["js2"], out["jout"] = jenv.step(js, jnp.asarray(mu))
    out["draws"] = jax_draws(js.rng, jenv.obs_dim)
    out["mu"] = torch.as_tensor(mu)
    del jenv._reset_states
    return out


def port_step(run, monkeypatch):
    """The port's step on the shared state with JAX's draws; returns (new
    state, output, the draw functions called)."""
    called = []
    draws = run["draws"]
    for opt, name in DRAWS.items():
        def fake(*args, _opt=opt):
            called.append(_opt)
            return draws[_opt]
        monkeypatch.setattr(pt, name, fake)
    ts = run["ts"].replace(rng=torch.Generator().manual_seed(0))
    ts2, out = run["env"]["A"].step(ts, run["mu"])
    return ts2, out, called


@pytest.mark.parametrize("option", list(OPTIONS))
def test_env_dims_match_jax(run, option):
    j, t = run["jenv"][OPTIONS[option]].cfg, run["env"][OPTIONS[option]].cfg
    for f in ("self_obs_dim", "task_obs_dim", "obs_dim", "num_sensor_points",
              "amp_obs_per_step"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(
        run["env"][OPTIONS[option]].sensor_flip_perm.numpy(),
        np.asarray(run["jenv"][OPTIONS[option]].sensor_flip_perm))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_observe_matches_jax(run, option):
    w = OPTIONS[option]
    o = run["env"][w].observe(run["ts"])
    assert o.shape == (N, run["env"][w].obs_dim)
    rel_close(o, run["jobs"][w], OBS_REL)


@pytest.mark.parametrize("option", STEP_OPTIONS)
def test_step_matches_jax_where_not_reset(run, monkeypatch, option):
    jout, js2 = run["jout"], run["js2"]
    done = np.asarray(jout.done)
    assert not done.any(), "an env reset on the first step"
    ts2, out, called = port_step(run, monkeypatch)
    assert called == ["action_noise", "push", "projectile", "obs_noise"]
    np.testing.assert_array_equal(out.done.numpy(), done)
    np.testing.assert_array_equal(out.terminated.numpy(),
                                  np.asarray(jout.terminated))
    for f in ("obs", "reward", "amp_obs", "reward_raw"):
        rel_close(getattr(out, f), getattr(jout, f), BF16)
    for f in ("root_pos", "root_rot", "joint_rot", "u", "body_x", "body_v",
              "contact_force"):
        rel_close(getattr(ts2.physics, f), getattr(js2.physics, f), BF16)
    for f in ("progress", "reset_buf", "terminate_buf", "cur_mid",
              "motion_sampled", "motion_term", "motion_succ",
              "motion_weights"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)))
    if option in DRAWS:
        # the step without this one draw's effect moves away from JAX's
        zero = jax.tree.map(torch.zeros_like, run["draws"][option])
        ts3, out3, _ = port_step(
            dict(run, draws={**run["draws"], option: zero}), monkeypatch)
        moved = (out3.obs - out.obs).abs().max() if option == "obs_noise" \
            else (ts3.physics.u - ts2.physics.u).abs().max()
        assert float(moved) > 1e-3


@pytest.mark.parametrize("option", list(OPTIONS))
def test_observe_flipped_from_matches_observe_flipped(run, option):
    env = run["env"][OPTIONS[option]]
    o = env.observe(run["ts"])
    torch.testing.assert_close(env.observe_flipped_from(o),
                               env.observe_flipped(run["ts"]), rtol=0,
                               atol=FLIP_ATOL)
    # the mirror is an involution
    torch.testing.assert_close(
        env.observe_flipped_from(env.observe_flipped_from(o)), o, rtol=0,
        atol=0)


def test_observe_with_traj_matches_jax(run):
    env, jenv = run["env"]["A"], run["jenv"]["A"]
    S = env.cfg.num_traj_samples
    traj = np.random.default_rng(8).normal(0, 2.0, (N, S, 3)).astype(
        np.float32)
    traj += run["ts"].physics.root_pos[:, None].numpy()
    want = jax.jit(jenv.observe_with_traj)(run["js"], jnp.asarray(traj))
    got = env.observe_with_traj(run["ts"], torch.as_tensor(traj))
    rel_close(got, want, OBS_REL)
    sd = env.cfg.self_obs_dim
    base = env.observe(run["ts"])
    torch.testing.assert_close(got[:, :sd], base[:, :sd], rtol=0, atol=0)
    torch.testing.assert_close(got[:, sd + 2 * S:], base[:, sd + 2 * S:],
                               rtol=0, atol=0)


def test_group_spawn_clusters():
    """Each group of consecutive envs spawns within the jitter box around
    its center."""
    env = PedestrianTerrainEnv(
        EnvConfig(num_envs=12, group_obs=True, group_size=4,
                  group_spawn_spread=1.0, sensor_res=8),
        convert.heightfield(np_tree(jgen(map_length=6.0, num_tiles=2)),
                            "cpu"),
        tml.synthetic_walk_motions(speeds=(1.0,), device="cpu"),
        device="cpu")
    xy = env._sample_spawn(torch.Generator().manual_seed(2), 12)
    assert xy.shape == (12, 2)
    span = xy.reshape(3, 4, 2).amax(1) - xy.reshape(3, 4, 2).amin(1)
    assert bool((span <= 2.0 + 1e-5).all())
    centers = xy.reshape(3, 4, 2).mean(1)
    assert float(torch.cdist(centers, centers).max()) > 2.0


def test_ragged_group_raises():
    """The port refuses an env count that is not a multiple of the group
    size at construction; the JAX package fails only when it observes."""
    with pytest.raises(ValueError, match="num_envs=12, group_size=8"):
        EnvConfig(num_envs=12, group_obs=True, group_size=8)
    assert EnvConfig(num_envs=12, group_obs=True, group_size=6)
    assert EnvConfig(num_envs=4, group_obs=True).obs_group_size == 4
    with pytest.raises(TypeError):
        jobs.group_obs(jnp.zeros((12, 24, 3)), jnp.zeros((12, 24, 3)),
                       jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (12, 1)), 8)
    with pytest.raises(ValueError, match="sensor_shape"):
        EnvConfig(sensor_shape="round")


def test_hard_negative_update_matches_jax():
    """Success rates and zeroed counts bit for bit; the weights within 8
    float32 ulps: XLA's CPU exp is not correctly rounded (about one result
    in ten differs from torch's by an ulp) and the sums run in other
    orders."""
    rng = np.random.default_rng(3)
    M = 40
    sampled = rng.integers(0, 30, M).astype(np.float32)
    sampled[:5] = 0.0
    term = np.minimum(rng.integers(0, 30, M), sampled).astype(np.float32)
    succ = rng.random(M).astype(np.float32)
    want = jml.hard_negative_update(jnp.asarray(succ), jnp.asarray(sampled),
                                    jnp.asarray(term), temp=0.2)
    got = tml.hard_negative_update(torch.as_tensor(succ),
                                   torch.as_tensor(sampled),
                                   torch.as_tensor(term), temp=0.2)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2.0 ** -21, atol=0)
    np.testing.assert_array_equal(got[1][:5].numpy(), succ[:5])


def test_hard_negative_bookkeeping_matches_jax(run, monkeypatch):
    """Six auto-resets with scripted dones, early terminations and fresh
    motion ids in both packages: the per-motion counts and each env's motion
    equal JAX's after each; then the refresh, and the demo fetch under the
    refreshed weights."""
    env, jenv = run["env"]["A"], run["jenv"]["A"]
    ts, js = run["ts"], run["js"]
    M = env.motion_lib.num_motions
    rng = np.random.default_rng(9)
    mids = {}

    def jstub(key, n, motion_weights=None):
        return js.physics, js.traj_verts, js.inverted, jnp.asarray(
            mids["now"], jnp.int32)

    def tstub(gen, n, motion_weights=None):
        return ts.physics, ts.traj_verts, ts.inverted, torch.as_tensor(
            mids["now"], dtype=torch.int32)

    monkeypatch.setattr(jenv, "_reset_states", jstub, raising=False)
    monkeypatch.setattr(env, "_reset_states", tstub, raising=False)
    jst, tst = js, ts
    for _ in range(6):
        done = rng.random(N) < 0.5
        term = done & (rng.random(N) < 0.5)
        mids["now"] = rng.integers(0, M, N)
        jst = jenv._auto_reset(jst.replace(terminate_buf=jnp.asarray(term)),
                               jnp.asarray(done))
        tst = env._auto_reset(tst.replace(terminate_buf=torch.as_tensor(
            term)), torch.as_tensor(done))
        for f in ("motion_sampled", "motion_term", "cur_mid"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                          np.asarray(getattr(jst, f)))
    assert float(tst.motion_sampled.sum()) > 0
    jst = jenv.apply_hard_negative_update(jst)
    tst = env.apply_hard_negative_update(tst)
    np.testing.assert_array_equal(tst.motion_succ.numpy(),
                                  np.asarray(jst.motion_succ))
    np.testing.assert_allclose(tst.motion_weights.numpy(),
                               np.asarray(jst.motion_weights),
                               rtol=2.0 ** -21, atol=0)
    assert float(tst.motion_sampled.abs().sum()) == 0.0
    # the demo fetch draws its motions under given weights
    gen = torch.Generator().manual_seed(1)
    only = torch.zeros(M)
    only[1] = 1.0
    ids, _ = env.sample_amp_demo(gen, 64, motion_weights=only)
    assert bool((ids == 1).all())
