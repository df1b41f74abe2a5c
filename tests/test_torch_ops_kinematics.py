"""emloco_tpu_torch against emloco_tpu: quaternions, FK, body model, motion
library, terrain, trajectories, observations, running norm.

Inputs are made with numpy from a seed and fed to both packages. These are
elementwise float32 computations in the same order, so outputs agree to a few
float32 ulps: FLOAT32_TOL allows 2e-6 relative plus 2e-6 absolute (near-zero
entries produced by cancellation), unless a test states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import observations as jobs
from emloco_tpu.envs import traj_gen as jtg
from emloco_tpu.kinematics import body_model as jbm
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.kinematics import skeleton as jsk
from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
from emloco_tpu.ops import quat as jq
from emloco_tpu.physics import terrain as jterrain
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import observations as tobs
from emloco_tpu_torch.envs import traj_gen as ttg
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.kinematics import skeleton as tsk
from emloco_tpu_torch.learning import RunningNorm
from emloco_tpu_torch.ops import quat as tq
from emloco_tpu_torch.physics import terrain as tterrain

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

FLOAT32_TOL = dict(rtol=2e-6, atol=2e-6)


def close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(torch_out.detach().cpu().numpy(),
                               np.asarray(jax_out), **(tol or FLOAT32_TOL))


def t(a):
    return torch.as_tensor(np.array(a))


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:4] = [[0, 0, 0, 1], [0, 0, 0, -1], [1, 0, 0, 0], [0, 0, 1e-7, 1]]
    return q.astype(np.float32)


def _exp_maps(rng, n):
    e = (rng.randn(n, 3) * 1.5).astype(np.float32)
    e[:3] = [[0, 0, 0], [1e-7, 0, 0], [np.pi, 0, 0]]
    return e


@pytest.fixture(scope="module")
def qdata():
    rng = np.random.RandomState(0)
    return dict(q=_quats(rng, 64), q2=_quats(rng, 64),
                v=rng.randn(64, 3).astype(np.float32),
                e=_exp_maps(rng, 64),
                ang=(rng.randn(64) * 3).astype(np.float32),
                axis=(lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True))(
                    rng.randn(64, 3)).astype(np.float32),
                s=rng.rand(64).astype(np.float32),
                euler=(rng.randn(3, 64) * 2).astype(np.float32))


QUAT_CASES = {
    "normalize": lambda m, d: m.normalize(2.5 * d["q"]),
    "mul": lambda m, d: m.mul(d["q"], d["q2"]),
    "conjugate": lambda m, d: m.conjugate(d["q"]),
    "rotate": lambda m, d: m.rotate(d["q"], d["v"]),
    "rotate_inv": lambda m, d: m.rotate_inv(d["q"], d["v"]),
    "from_angle_axis": lambda m, d: m.from_angle_axis(d["ang"], d["axis"]),
    "to_angle_axis": lambda m, d: m.to_angle_axis(d["q"]),
    "to_exp_map": lambda m, d: m.to_exp_map(d["q"]),
    "exp_map_to_quat": lambda m, d: m.exp_map_to_quat(d["e"]),
    "to_tan_norm": lambda m, d: m.to_tan_norm(d["q"]),
    "slerp": lambda m, d: m.slerp(d["q"], d["q2"], d["s"]),
    "calc_heading": lambda m, d: m.calc_heading(d["q"]),
    "heading_quat": lambda m, d: m.heading_quat(d["q"]),
    "heading_quat_inv": lambda m, d: m.heading_quat_inv(d["q"]),
    "from_euler_xyz": lambda m, d: m.from_euler_xyz(*d["euler"]),
    "to_matrix": lambda m, d: m.to_matrix(d["q"]),
    "from_matrix": lambda m, d: m.from_matrix(m.to_matrix(d["q"])),
    "angular_velocity": lambda m, d: m.angular_velocity(d["q"], d["q2"],
                                                        1 / 30),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_matches_jax(name, qdata):
    fn = QUAT_CASES[name]
    jout = fn(jq, {k: jnp.asarray(v) for k, v in qdata.items()})
    tout = fn(tq, {k: t(v) for k, v in qdata.items()})
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    tol = FLOAT32_TOL
    if name in ("to_angle_axis", "to_exp_map", "angular_velocity"):
        # acos near |w| = 1 magnifies a 1-ulp difference of its result
        # (d acos/dw = 1/sin) — 1e-5 covers the drawn quaternions
        tol = dict(rtol=1e-5, atol=1e-5)
    if name == "angular_velocity":
        tol = dict(rtol=1e-5, atol=3e-4)       # the angle is divided by dt
    for a, b in zip(jout, tout):
        close(a, b, **tol)


def test_exp_map_drops_a_rotation_whose_w_rounds_to_one():
    """A fault of the reference that the port shares (ROADMAP §C):
    to_angle_axis takes the angle from acos(w) alone, so a near-identity
    quaternion whose w rounds to 1.0 in float32 maps to the zero rotation
    whatever its xyz, while the next float32 below 1 gives about 2·xyz. The
    quaternion is the PD error q_rel·conj(target) of a joint in one step of
    the 8-env bench rollout: a 2.1 mrad rotation whose w rounded to 1.0 on
    one device and to 1 − 2⁻²² on the other after float32 rounding of the
    LHS sums. The PD spring (physics/reduced.py `_gravity_bias_spring`)
    takes its error from to_exp_map, so its torque kp·θ is there on one
    device and not on the other: the card-vs-CPU gap of that step. Both
    packages agree on both inputs; a fix changes this test."""
    xyz = np.array([-3.2594055e-4, -3.0726194e-5, 9.926558e-4], np.float32)
    below_one = np.nextafter(np.float32(1.0), np.float32(0.0))
    q = np.stack([np.append(xyz, np.float32(1.0)),
                  np.append(xyz, below_one)]).astype(np.float32)
    for e in (tq.to_exp_map(torch.as_tensor(q)).numpy(),
              np.asarray(jq.to_exp_map(jnp.asarray(q)))):
        assert (e[0] == 0).all()
        np.testing.assert_allclose(e[1], 2 * xyz, rtol=1e-3)
        assert np.linalg.norm(e[1]) > 2e-3                  # a 2.1 mrad error


def test_forward_kinematics_matches_jax():
    rng = np.random.RandomState(1)
    tree_j = jbm.canonical_skeleton()
    tree_t = tbm.canonical_skeleton()
    lr = np.asarray(jq.exp_map_to_quat(jnp.asarray(
        rng.randn(5, 24, 3).astype(np.float32) * 0.7)))
    root = rng.randn(5, 3).astype(np.float32)
    offs = (jbm._MEAN_OFFSETS[None] * (1 + 0.1 * rng.randn(5, 24, 1))
            ).astype(np.float32)
    for lt in (None, offs):
        jr, jp = jsk.forward_kinematics(
            tree_j, jnp.asarray(lr), jnp.asarray(root),
            None if lt is None else jnp.asarray(lt))
        tr, tp = tsk.forward_kinematics(
            tree_t, t(lr), t(root), None if lt is None else t(lt))
        close(jr, tr)
        close(jp, tp)
    close(jsk.local_from_global(tree_j, jr),
          tsk.local_from_global(tree_t, tr))


def test_body_params_match_jax():
    betas = np.random.RandomState(2).randn(6, 16).astype(np.float32)
    jp = jbm.build_body_params(jnp.asarray(betas))
    tp = tbm.build_body_params(betas, device="cpu")
    assert tbm.NUM_JOINTS == jbm.NUM_JOINTS == 23
    assert tbm.NUM_BODIES == jbm.NUM_BODIES == 24
    for f in ("local_offsets", "capsule_radius", "capsule_half",
              "capsule_axis", "capsule_start", "mass", "inv_mass", "inertia",
              "inv_inertia", "kp", "kd", "torque_limit", "joint_limit",
              "betas", "height_offset", "friction_scale", "mesh_points",
              "mesh_point_radius"):
        # kp/kd scale with Σ mass, summed in another order: 1-ulp relative
        close(getattr(jp, f), getattr(tp, f), rtol=4e-6, atol=2e-6)


@pytest.fixture(scope="module")
def jax_lib():
    return jml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0)


def test_synthetic_walk_motions_match_jax(jax_lib):
    tlib = tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                      device="cpu")
    for f in ("local_rot", "root_pos", "root_vel", "root_ang_vel", "key_pos",
              "betas", "fps", "length_starts", "num_frames", "durations",
              "weights"):
        close(getattr(jax_lib, f), getattr(tlib, f))
    # finite-difference joint velocities divide an acos by dt = 1/30
    close(jax_lib.dof_vel, tlib.dof_vel, rtol=1e-5, atol=1e-5)


def test_motion_state_query_matches_jax(jax_lib):
    tlib = convert.motion_lib(jax.tree.map(np.asarray, jax_lib),
                              device="cpu")
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 2, 32).astype(np.int32)
    times = (rng.rand(32) * 2.2).astype(np.float32)       # past the end too
    js = jml.get_motion_state(jax_lib, jnp.asarray(ids), jnp.asarray(times))
    ts = tml.get_motion_state(tlib, t(ids).long(), t(times))
    for k in js:
        # slerp and the exp map go through acos (see test_quat_matches_jax)
        close(js[k], ts[k], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def terrains():
    jt = jterrain.generate_mixed_terrain(map_length=4.0, num_tiles=3,
                                         difficulty=0.8, seed=5)
    tt = tterrain.generate_mixed_terrain(map_length=4.0, num_tiles=3,
                                         difficulty=0.8, seed=5,
                                         device="cpu")
    return jt, tt


def test_mixed_terrain_matches_jax(terrains):
    jt, tt = terrains
    np.testing.assert_array_equal(tt.heights.numpy(), np.asarray(jt.heights))
    np.testing.assert_array_equal(tt.corner_tex.numpy(),
                                  np.asarray(jt.corner_tex))
    assert tt.cell == jt.cell and tt.origin == jt.origin
    heights = np.asarray(jt.heights)
    np.testing.assert_array_equal(
        tterrain.walkable_mask(heights, jt.cell),
        jterrain.walkable_mask(heights, jt.cell))
    # the spawn table holds the same walkable cells; the JAX package may
    # build it with its C++ helper, which rounds x·cell + origin in float32
    # (the numpy path here rounds once, from float64): 1 ulp at |x| ≤ 8 m
    a = np.asarray(jt.spawnable_xy)
    b = tt.spawnable_xy.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["height_at", "normal_at",
                                "height_and_normal_at", "height_at_min2"])
def test_terrain_queries_match_jax(terrains, fn):
    jt, tt = terrains
    xy = (np.random.RandomState(4).rand(200, 2) * 16 - 8).astype(np.float32)
    jout = getattr(jterrain, fn)(jt, jnp.asarray(xy))
    tout = getattr(tterrain, fn)(tt, t(xy))
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for a, b in zip(jout, tout):
        close(a, b)


def test_real_bank_and_trajectory_queries_match_jax():
    jb = jtg.synthetic_real_bank(num_paths=8)
    tb = ttg.synthetic_real_bank(num_paths=8, device="cpu")
    close(jb, tb)
    rng = np.random.RandomState(6)
    verts = (np.cumsum(rng.randn(5, 101, 3), 1) * 0.1).astype(np.float32)
    times = (rng.rand(5) * 12 - 0.5).astype(np.float32)   # clamps both ends
    close(jtg.calc_pos(jnp.asarray(verts), jnp.asarray(times), 11.2),
          ttg.calc_pos(t(verts), t(times), 11.2))
    close(jtg.fetch_samples(jnp.asarray(verts), jnp.asarray(times), 11.2,
                            15, 0.4),
          ttg.fetch_samples(t(verts), t(times), 11.2, 15, 0.4))
    init = rng.randn(5, 3).astype(np.float32)
    vel = rng.randn(5, 3).astype(np.float32)
    inv = np.array([True, False, True, False, False])
    close(jtg.align_real_paths(jb[:5], jnp.asarray(init), jnp.asarray(vel),
                               invert=jnp.asarray(inv)),
          ttg.align_real_paths(tb[:5], t(init), t(vel), invert=t(inv)),
          rtol=1e-5, atol=1e-5)


def test_procedural_trajectories_are_bounded():
    """jax.random streams cannot be reproduced in torch: check the port's
    random walks by their invariants instead (start point, speed caps)."""
    cfg = ttg.TrajConfig(episode_dur=11.2)
    init = torch.randn(64, 3)
    vel = torch.randn(64, 3)
    gen = torch.Generator().manual_seed(0)
    verts = ttg.procedural_verts(gen, 64, cfg, init, vel)
    assert verts.shape == (64, cfg.num_verts, 3)
    torch.testing.assert_close(verts[:, 0, :2], init[:, :2])
    step = torch.linalg.norm(verts[:, 2:, :2] - verts[:, 1:-1, :2], dim=-1)
    assert float(step.max()) <= cfg.speed_max * cfg.dt * (1 + 1e-5)
    again = ttg.procedural_verts(torch.Generator().manual_seed(0), 64, cfg,
                                 init, vel)
    torch.testing.assert_close(verts, again, rtol=0, atol=0)


@pytest.fixture(scope="module")
def body_state():
    rng = np.random.RandomState(7)
    n = 6
    q = rng.randn(n, 24, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(pos=rng.randn(n, 24, 3).astype(np.float32), rot=q,
                vel=rng.randn(n, 24, 3).astype(np.float32),
                ang=rng.randn(n, 24, 3).astype(np.float32),
                betas=rng.randn(n, 16).astype(np.float32),
                dof_pos=(rng.randn(n, 23, 3) * 0.5).astype(np.float32),
                dof_vel=rng.randn(n, 23, 3).astype(np.float32),
                samples=rng.randn(n, 15, 3).astype(np.float32))


def test_self_obs_matches_jax(body_state):
    d = body_state
    args = [d[k] for k in ("pos", "rot", "vel", "ang")]
    jo = jobs.humanoid_obs_max(*map(jnp.asarray, args),
                               betas=jnp.asarray(d["betas"]))
    to = tobs.humanoid_obs_max(*map(t, args), betas=t(d["betas"]))
    assert to.shape[-1] == tobs.SELF_OBS_DIM + 11
    close(jo, to, rtol=1e-5, atol=1e-5)


def test_amp_obs_matches_jax(body_state):
    d = body_state
    key = d["pos"][:, tobs.KEY_BODY_IDS]
    args = [d["pos"][:, 0], d["rot"][:, 0], d["vel"][:, 0], d["ang"][:, 0],
            d["dof_pos"], d["dof_vel"], key]
    jo = jobs.amp_obs(*map(jnp.asarray, args), betas=jnp.asarray(d["betas"]))
    to = tobs.amp_obs(*map(t, args), betas=t(d["betas"]))
    assert to.shape[-1] == tobs.AMP_OBS_DIM + 11
    close(jo, to, rtol=1e-5, atol=1e-5)


def test_location_obs_matches_jax(body_state):
    d = body_state
    args = [d["pos"][:, 0], d["rot"][:, 0], d["samples"]]
    close(jobs.location_obs(*map(jnp.asarray, args)),
          tobs.location_obs(*map(t, args)), rtol=1e-5, atol=1e-5)


def test_heightmap_obs_matches_jax(terrains):
    jt, tt = terrains
    rng = np.random.RandomState(8)
    n = 6
    pos = np.concatenate([rng.rand(n, 2) * 10 - 5, rng.rand(n, 1)],
                         -1).astype(np.float32)
    rot = _quats(rng, n)
    center = (pos[:, :2] + 0.1).astype(np.float32)
    grid = jobs.make_sensor_grid(2.0, 16)
    np.testing.assert_array_equal(tobs.make_sensor_grid(2.0, 16), grid)
    close(jobs.heightmap_obs(jt, jnp.asarray(pos), jnp.asarray(rot),
                             jnp.asarray(center), grid),
          tobs.heightmap_obs(tt, t(pos), t(rot), t(center), grid),
          rtol=1e-5, atol=1e-5)


def test_running_norm_matches_jax():
    rng = np.random.RandomState(9)
    a = (rng.randn(32, 7) * 3 + 1).astype(np.float32)
    b = (rng.randn(16, 7) * 0.5).astype(np.float32)
    jn = JRunningNorm.create(7).update(jnp.asarray(a)).update(jnp.asarray(b))
    tn = RunningNorm.create(7, device="cpu").update(t(a)).update(t(b))
    for f in ("mean", "var", "count"):
        close(getattr(jn, f), getattr(tn, f), rtol=1e-5, atol=1e-6)
    close(jn.normalize(jnp.asarray(a)), tn.normalize(t(a)),
          rtol=1e-5, atol=1e-5)
