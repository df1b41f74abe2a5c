"""emloco_tpu_torch.envs and .learning against emloco_tpu: observe, the
running norm, the actor (weights carried over by convert.py) and one
env.step, at 8 envs, sensor_res 16, 5 AMP steps.

jax.random streams cannot be reproduced in torch, so the port starts from
the JAX reset state (convert.env_state) and only envs that did not reset are
compared; the test asserts that none resets on this first step. The step's
physics runs bfloat16 Jacobian rows, whose rounding can land on the other
bf16 neighbour in either package: tolerances are one bf16 ulp (2^-8) of each
quantity's largest magnitude. Observations and the actor are float32 work in
the same order: 1e-5 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs.pedestrian_terrain import DRConfig as JDRConfig
from emloco_tpu.envs import EnvConfig as JEnvConfig
from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.learning.networks import AMPSeptValueNet as JNet
from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import DRConfig, EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.envs import traj_gen as ttg
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning import AMPSeptValueNet, RunningNorm
from emloco_tpu_torch.physics import body_frame_state, generate_mixed_terrain
from emloco_tpu_torch.rollout import build_bench

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 8
SMALL = dict(num_envs=N, sensor_res=16, episode_length=48,
             num_amp_obs_steps=5)
BF16 = 2.0 ** -8


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


@pytest.fixture(scope="module")
def run():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    jlib = jml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0)
    jcfg = JEnvConfig(**SMALL)
    jenv = JEnv(jcfg, jterr, jlib)
    js = jenv.reset(jax.random.PRNGKey(0))
    jo = jenv.observe(js)
    net = JNet(num_actions=jcfg.num_actions, self_obs_dim=jcfg.self_obs_dim,
               traj_obs_dim=jcfg.num_traj_samples * 2,
               task_obs_dim=jcfg.task_obs_dim)
    params = net.init(jax.random.PRNGKey(1), jo,
                      jnp.zeros((N, jcfg.amp_obs_per_step * 5)))
    norm = JRunningNorm.create(jcfg.obs_dim).update(jo)
    on = norm.normalize(jo)
    mu, sigma = net.apply(params, on, method=net.actor)
    js2, jout = jenv.step(js, mu)

    cfg = EnvConfig(**SMALL)
    env = PedestrianTerrainEnv(cfg, convert.heightfield(np_tree(jterr), "cpu"),
                               convert.motion_lib(np_tree(jlib), "cpu"),
                               device="cpu")
    ts = convert.env_state(np_tree(js), torch.Generator().manual_seed(0),
                           "cpu")
    actor = AMPSeptValueNet(cfg.num_actions, cfg.self_obs_dim,
                            cfg.num_traj_samples * 2, cfg.task_obs_dim,
                            cfg.amp_obs_per_step * 5, device="cpu")
    # the actor's layers only; the other heads keep their own weights
    missing, unexpected = actor.load_state_dict(
        convert.actor_state_dict(np_tree(params)), strict=False)
    assert not unexpected
    assert missing and not any(k.startswith(("task_mlp.", "actor_mlp.",
                                             "mu.", "log_sigma"))
                               for k in missing)
    return dict(jenv=jenv, js=js, jo=jo, on=on, mu=mu, sigma=sigma, js2=js2,
                jout=jout, env=env, ts=ts, actor=actor,
                norm=convert.running_norm(np_tree(norm), "cpu"))


def test_env_dims_match_jax():
    j, t = JEnvConfig(**SMALL), EnvConfig(**SMALL)
    for f in ("self_obs_dim", "task_obs_dim", "obs_dim", "amp_obs_per_step",
              "num_actions", "num_sensor_points", "dt"):
        assert getattr(t, f) == getattr(j, f), f


def test_observe_matches_jax(run):
    rel_close(run["env"].observe(run["ts"]), run["jo"], 1e-5)


def test_actor_matches_jax(run):
    o = run["env"].observe(run["ts"])
    on = run["norm"].normalize(o)
    # (x − mean)/√(var + 1e-5) magnifies observation rounding where the
    # batch variance is ~0
    rel_close(on, run["on"], 1e-4)
    with torch.no_grad():
        mu, sigma = run["actor"].actor(torch.as_tensor(np.array(run["on"])))
    rel_close(mu, run["mu"], 1e-5)
    rel_close(sigma, run["sigma"], 1e-6)


def test_step_matches_jax_where_not_reset(run):
    jout, js2 = run["jout"], run["js2"]
    done = np.asarray(jout.done)
    assert not done.any(), "an env reset on the first step"
    ts2, out = run["env"].step(run["ts"], torch.as_tensor(np.array(run["mu"])))
    np.testing.assert_array_equal(out.done.numpy(), done)
    np.testing.assert_array_equal(out.terminated.numpy(),
                                  np.asarray(jout.terminated))
    for f in ("obs", "reward", "amp_obs", "reward_raw"):
        rel_close(getattr(out, f), getattr(jout, f), BF16)
    for f in ("root_pos", "root_rot", "joint_rot", "u", "body_x", "body_v",
              "contact_force"):
        rel_close(getattr(ts2.physics, f), getattr(js2.physics, f), BF16)
    for f in ("traj_verts", "waypoint_traj", "init_pose", "init_vel",
              "amp_obs_hist", "dr_scales"):
        rel_close(getattr(ts2, f), getattr(js2, f), BF16)
    for f in ("progress", "reset_buf", "terminate_buf", "inverted",
              "dr_clock", "dr_last"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)))


def test_dr_model_matches_jax(run):
    """Domain randomization folds the per-env scales into the body."""
    dr = dict(num_envs=N, sensor_res=8, num_amp_obs_steps=2)
    jenv = JEnv(JEnvConfig(**dr, dr=JDRConfig(enabled=True)),
                run["jenv"].terrain, run["jenv"].motion_lib)
    env = PedestrianTerrainEnv(EnvConfig(**dr, dr=DRConfig(enabled=True)),
                               run["env"].terrain, run["env"].motion_lib,
                               device="cpu")
    js = jenv.reset(jax.random.PRNGKey(2))
    ts = convert.env_state(np_tree(js), torch.Generator(), "cpu")
    jp, tp = jenv._dr_model(js).params, env._dr_model(ts).params
    for f in ("mass", "inv_mass", "inertia", "inv_inertia", "kp", "kd",
              "friction_scale", "capsule_radius", "mesh_point_radius"):
        rel_close(getattr(tp, f), getattr(jp, f), 2e-6)
    s = env._sample_dr_scales(torch.Generator().manual_seed(0), 1000,
                              torch.tensor(0))
    lo = torch.tensor([0.8, 0.85, 0.85, 0.7, -0.005])
    hi = torch.tensor([1.2, 1.15, 1.15, 1.3, 0.005])
    assert bool(((s >= lo) & (s <= hi)).all())


def test_port_reset_and_rollout():
    """The port's own reset (torch.Generator) with a real-path bank, then
    steps through a truncation so the auto-reset runs: seeded, finite, the
    expected shapes, trajectories starting under the root."""
    cfg = EnvConfig(num_envs=4, sensor_res=8, episode_length=3,
                    num_amp_obs_steps=3)
    terrain = generate_mixed_terrain(map_length=4.0, num_tiles=2,
                                     difficulty=0.5, device="cpu")
    lib = tml.synthetic_walk_motions(speeds=(1.0,), duration=2.0,
                                     device="cpu")
    bank = ttg.synthetic_real_bank(num_paths=8, device="cpu")
    env = PedestrianTerrainEnv(cfg, terrain, lib, real_traj_bank=bank,
                               device="cpu")
    a = env.reset(torch.Generator().manual_seed(5))
    root = body_frame_state(env.model, a.physics)[0][:, 0, :2]
    torch.testing.assert_close(a.traj_verts[:, 0, :2], root)
    b = env.reset(torch.Generator().manual_seed(5))
    torch.testing.assert_close(env.observe(a), env.observe(b), rtol=0,
                               atol=0)
    actor = AMPSeptValueNet(cfg.num_actions, cfg.self_obs_dim,
                            cfg.num_traj_samples * 2, cfg.task_obs_dim,
                            cfg.num_amp_obs_steps * cfg.amp_obs_per_step,
                            generator=torch.Generator().manual_seed(1),
                            device="cpu")
    norm = RunningNorm.create(cfg.obs_dim, device="cpu")
    st = a
    for i in range(2):
        o = env.observe(st)
        assert o.shape == (4, cfg.obs_dim) and bool(torch.isfinite(o).all())
        with torch.no_grad():
            mu, _ = actor.actor(norm.normalize(o))
        st, out = env.step(st, mu)
        assert out.amp_obs.shape == (4, 3 * cfg.amp_obs_per_step)
        assert bool(torch.isfinite(st.physics.u).all())
    assert bool(out.done.all())      # truncated: progress 2 ≥ length − 1
    assert bool((st.progress == 0).all())         # and reset


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_mixed_terrain(map_length=4.0, num_tiles=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tml.synthetic_walk_motions(speeds=(1.0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RunningNorm.create(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMPSeptValueNet(69, 10, 4, 8, 6, mlp_units=(4,), task_units=(4,))
    terrain = generate_mixed_terrain(map_length=4.0, num_tiles=1,
                                     device="cpu")
    lib = tml.synthetic_walk_motions(speeds=(1.0,), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PedestrianTerrainEnv(EnvConfig(num_envs=2), terrain, lib)


def test_bench_rollout_control_step_on_cpu(monkeypatch):
    """The bench configuration's builder (shared by chip_smoke.py and
    profile_step) at 2 envs: its settings, one finite control step, and no
    card taken without one unless the CPU is asked for."""
    r = build_bench(num_envs=2, device="cpu")
    assert (r.cfg.sensor_res, r.cfg.num_amp_obs_steps,
            r.cfg.episode_length) == (32, 15, 168)
    st = r.env.reset(torch.Generator().manual_seed(0))
    st, out, o, mu = r.control_step(st)
    assert o.shape == (2, r.cfg.obs_dim) and mu.shape == (2, r.cfg.num_actions)
    assert out.obs.shape == (2, r.cfg.obs_dim)
    assert all(bool(torch.isfinite(t).all())
               for t in (o, mu, out.reward, st.physics.u))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_bench(num_envs=2)
