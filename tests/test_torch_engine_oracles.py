"""Physical oracles of the port's engine on its own, over long rollouts.

Ports of the oracles of tests/test_engine.py (freefall, standing, weight on
ground, PD tracking, gravity sag, joint limits, no penetration, violent
impacts, torque saturation) with the JAX tests' own setups, lengths and
thresholds, run on the port alone on the CPU at 1-4 envs: nothing else
checks the port's rollouts beyond three steps. Standing and weight on ground
also run under `gram_kernel=True`, whose LHS comes from the gram_diag
kernel's plain version here. The contact variants' oracles follow:
self-contact push-out (tests/test_engine.py:329), mesh-collider standing
(:394), the SMPL-fixture colliders (:422) and their beta shift (:678).
"""
import os

import numpy as np
import pytest
import torch

from emloco_tpu_torch.kinematics import body_model as bm
from emloco_tpu_torch.ops import quat
from emloco_tpu_torch.physics import (EngineConfig, build_model,
                                      default_tree, flat_terrain,
                                      joint_state, kinematic_state, step)

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

TREE = default_tree()
CFG = EngineConfig(n_substeps=4)
GRAM_CFG = EngineConfig(n_substeps=4, gram_kernel=True)


def make_world(n_envs=1):
    model = build_model(bm.build_body_params(torch.zeros((n_envs, 16)),
                                             device="cpu"))
    return model, flat_terrain(extent=20.0, cell=0.1, device="cpu")


def rest_state(model, z=None):
    n = model.num_envs
    if z is None:
        z = model.params.height_offset[:, None]
    root_pos = torch.cat([torch.zeros((n, 2)),
                          torch.as_tensor(z, dtype=torch.float32)
                          .expand(n, 1)], -1)
    return kinematic_state(model, TREE, root_pos, quat.identity_like((n,)),
                           quat.identity_like((n, bm.NUM_BODIES)))


def rollout(model, terrain, st, target, cfg, steps):
    for _ in range(steps):
        st = step(model, terrain, st, target, cfg)
    return st


def test_freefall_com():
    """With no ground (start high), the COM follows projectile motion."""
    model, terrain = make_world()
    st = rest_state(model, z=[[5.0]])
    m = model.params.mass[0][:, None]
    com0 = (st.body_x[0] * m).sum(0) / m.sum()
    T = 6
    st = rollout(model, terrain, st, torch.zeros((1, 23, 3)), CFG, T)
    com1 = (st.body_x[0] * m).sum(0) / m.sum()
    t = T * CFG.control_dt
    expected_drop = 0.5 * 9.81 * t ** 2
    drop = float(com0[2] - com1[2])
    assert abs(drop - expected_drop) / expected_drop < 0.1
    assert abs(float(com1[0] - com0[0])) < 1e-3


@pytest.mark.parametrize("cfg", [CFG, GRAM_CFG], ids=["sqrt_gram", "gram"])
def test_standing_stability(cfg):
    """PD holding the rest pose keeps the humanoid upright for 1.5 s with
    the pose essentially unperturbed."""
    model, terrain = make_world()
    st = rest_state(model)
    head = TREE.index("Head")
    z0 = float(st.body_x[0, head, 2])
    st = rollout(model, terrain, st, torch.zeros((1, 23, 3)), cfg, 45)
    assert bool(torch.isfinite(st.body_x).all())
    z1 = float(st.body_x[0, head, 2])
    assert z1 > 0.9 * z0, f"head dropped from {z0:.2f} to {z1:.2f}"
    dof_pos, _ = joint_state(model, st)
    assert float(dof_pos.abs().max()) < 0.2, "pose not held"


@pytest.mark.parametrize("cfg", [CFG, GRAM_CFG], ids=["sqrt_gram", "gram"])
def test_weight_on_ground(cfg):
    """The total normal contact force equals the body weight once
    settled."""
    model, terrain = make_world()
    st = rollout(model, terrain, rest_state(model),
                 torch.zeros((1, 23, 3)), cfg, 20)
    total_fz = float(st.contact_force[0, :, 2].sum())
    weight = float(model.params.mass[0].sum() * 9.81)
    assert abs(total_fz - weight) / weight < 0.1, (total_fz, weight)


def test_pd_tracks_target():
    """An elbow exp-map target is reached accurately."""
    model, terrain = make_world()
    target = torch.zeros((1, 23, 3))
    jidx = TREE.index("L_Elbow") - 1
    target[0, jidx, 1] = 0.8
    st = rollout(model, terrain, rest_state(model, z=[[5.0]]), target, CFG,
                 15)
    dof_pos, _ = joint_state(model, st)
    got = float(dof_pos[0, jidx, 1])
    assert abs(got - 0.8) < 0.1, f"elbow angle {got:.3f} vs target 0.8"


def test_gravity_sag_matches_kp():
    """The static sag under gravity is about τ_gravity / kp."""
    model, terrain = make_world()
    st = rollout(model, terrain, rest_state(model, z=[[50.0]]),
                 torch.zeros((1, 23, 3)), CFG, 20)
    dof_pos, _ = joint_state(model, st)
    sh = TREE.index("L_Shoulder") - 1
    sag = float(torch.linalg.norm(dof_pos[0, sh]))
    assert sag < 0.1, f"shoulder sag {sag:.3f} too large (drive too soft)"


def test_joint_limits_enforced():
    """Targets far beyond the limit cannot push the joint past it."""
    model, terrain = make_world()
    target = torch.zeros((1, 23, 3))
    jidx = TREE.index("Head") - 1               # Head limits ±π/2
    target[0, jidx, 0] = 3.0
    st = rollout(model, terrain, rest_state(model, z=[[5.0]]), target, CFG,
                 20)
    dof_pos, _ = joint_state(model, st)
    assert float(dof_pos[0, jidx, 0]) < np.pi / 2 + 0.05


def test_no_ground_penetration():
    model, terrain = make_world()
    st = rollout(model, terrain, rest_state(model), torch.zeros((1, 23, 3)),
                 CFG, 30)
    low = st.body_x[0, :, 2] - model.params.capsule_radius[0]
    assert float(low.min()) > -0.05, f"body sunk to {float(low.min()):.3f}"


def test_violent_impacts_stay_finite():
    """A drop from 3 m with a 10 m/s horizontal launch and a spin settles
    to a finite, bounded state over 8 s at the default configuration."""
    n = 4
    model = build_model(bm.build_body_params(torch.zeros((n, 16)),
                                             device="cpu"))
    terrain = flat_terrain(extent=40.0, cell=0.1, device="cpu")
    st = kinematic_state(
        model, TREE,
        root_pos=torch.tensor([0.0, 0.0, 3.0]).repeat(n, 1),
        root_rot=quat.identity_like((n,)),
        local_rot=quat.identity_like((n, 24)),
        root_vel=torch.tensor([10.0, 0.0, -3.0]).repeat(n, 1),
        root_ang_vel=torch.tensor([0.0, 6.0, 0.0]).repeat(n, 1))
    st = rollout(model, terrain, st, torch.zeros((n, 23, 3)),
                 EngineConfig(), 240)
    assert bool(torch.isfinite(st.u).all())
    assert bool(torch.isfinite(st.body_x).all())
    assert float(st.u.abs().max()) < 50.0       # settled, not ringing
    assert float(st.body_x[..., 2].min()) > -0.5


def test_actuator_torque_saturation():
    """Drive torques saturate at the torque limits: a step toward a far
    pose accelerates the joints strictly less than one with the limits
    lifted."""
    model, terrain = make_world(2)
    st = rest_state(model)
    tgt = torch.full((2, bm.NUM_JOINTS, 3), 2.5)
    _, dof_vel_capped = joint_state(model, step(model, terrain, st, tgt,
                                                CFG))
    uncapped = model.replace(params=model.params.replace(
        torque_limit=torch.full_like(model.params.torque_limit, 1e9)))
    _, dof_vel_free = joint_state(uncapped, step(uncapped, terrain, st, tgt,
                                                 CFG))
    v_cap = float(dof_vel_capped.abs().max())
    v_free = float(dof_vel_free.abs().max())
    assert np.isfinite(v_cap) and np.isfinite(v_free)
    assert v_cap < v_free * 0.75, (v_cap, v_free)


FIXTURE = os.path.join(os.path.dirname(__file__), "data", "smpl_fixture.npz")


def test_self_contact_rest_clearance_and_pushout():
    """The rest pose clears every pair by 2 cm; an arm PD-held inside the
    torso is pushed out with self-contact on (implicit and TGS) and stays
    buried with it off; the pair force reaches the arm's body; at rest the
    flag changes nothing."""
    from emloco_tpu_torch.physics import reduced as R
    model, terrain = make_world(2)
    st = rest_state(model)
    pen = R._self_contact_geometry(model, st.body_x, st.body_q)[3]
    assert float(pen.max()) < -0.02
    names = bm.BODY_NAMES
    j_sh, j_el = names.index("L_Shoulder") - 1, names.index("L_Elbow") - 1
    target = torch.zeros((2, 23, 3))
    target[:, j_sh, 0] = -2.2
    target[:, j_el, 1] = 1.2
    loc = quat.identity_like((2, bm.NUM_BODIES))
    loc[:, j_sh + 1] = quat.exp_map_to_quat(target[:, j_sh])
    loc[:, j_el + 1] = quat.exp_map_to_quat(target[:, j_el])
    st0 = kinematic_state(model, TREE, torch.tensor([[0., 0., 1.]] * 2),
                          quat.identity_like((2,)), loc)
    pen0 = R._self_contact_geometry(model, st0.body_x, st0.body_q)[3]
    k = int(pen0[0].argmax())
    assert float(pen0[:, k].min()) > 0.08
    for tgs in (False, True):
        on = EngineConfig(n_substeps=2, self_contact=True, tgs_step=tgs)
        off = EngineConfig(n_substeps=2, tgs_step=tgs)
        s_on = rollout(model, terrain, st0, target, on, 20)
        s_off = rollout(model, terrain, st0, target, off, 20)
        assert bool(torch.isfinite(s_on.body_x).all())
        p_on = R._self_contact_geometry(model, s_on.body_x, s_on.body_q)[3]
        p_off = R._self_contact_geometry(model, s_off.body_x,
                                         s_off.body_q)[3]
        assert float(p_on[:, k].max()) < 0.03, (tgs, p_on[:, k])
        assert float(p_off[:, k].min()) > 0.08, (tgs, p_off[:, k])
    on = EngineConfig(n_substeps=2, self_contact=True)
    s1 = step(model, terrain, st0, target, on)
    assert float(s1.contact_force[:, R._SELF_A[k]].abs().max()) > 1.0
    s_rest = step(model, terrain, rest_state(model), torch.zeros((2, 23, 3)),
                  on)
    s_rest_off = step(model, terrain, rest_state(model),
                      torch.zeros((2, 23, 3)), EngineConfig(n_substeps=2))
    torch.testing.assert_close(s_rest.body_x, s_rest_off.body_x, rtol=0,
                               atol=1e-5)


def test_mesh_contact_variant():
    """With the capsule-axis collision spheres the standing humanoid carries
    its weight on its feet and stays up, implicit and TGS."""
    model, terrain = make_world(1)
    weight = float(model.params.mass[0].sum() * 9.81)
    feet = [bm.BODY_NAMES.index(n)
            for n in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")]
    for tgs in (False, True):
        cfg = EngineConfig(n_substeps=4, mesh_contacts=True, tgs_step=tgs)
        st = rollout(model, terrain, rest_state(model),
                     torch.zeros((1, 23, 3)), cfg, 20)
        fz = st.contact_force[0, :, 2]
        total = float(fz.sum())
        assert abs(total - weight) / weight < 0.1, (tgs, total, weight)
        assert float(fz[feet].sum()) > 0.9 * total
        assert float(st.root_pos[0, 2]) > 0.5 * float(
            model.params.height_offset[0])


def test_mesh_points_from_smpl_fixture():
    """from_smpl_npz's colliders: static shapes, radii in [0, 0.3), centre
    plus radius inside 1.2 m, and the mesh variant runs on them."""
    betas = torch.zeros((2, 10))
    betas[1, 0] = 1.0
    bp = bm.from_smpl_npz(FIXTURE, betas, device="cpu")
    assert bp.mesh_points.shape == (2, bm.NUM_BODIES, bm.MESH_K, 3)
    assert bp.mesh_point_radius.shape == (2, bm.NUM_BODIES, bm.MESH_K)
    r = bp.mesh_point_radius
    assert float(r.min()) >= 0.0 and float(r.max()) < 0.3
    c = bp.mesh_points.norm(dim=-1)
    assert bool((c + r < 1.2).all())
    model = build_model(bp)
    terrain = flat_terrain(extent=20.0, cell=0.1, device="cpu")
    st = rollout(model, terrain, rest_state(model), torch.zeros((2, 23, 3)),
                 EngineConfig(n_substeps=2, mesh_contacts=True), 5)
    assert bool(torch.isfinite(st.body_x).all())


def test_mesh_colliders_beta_variation_shifts_contacts():
    """Fitted colliders move with the betas, and two shapes knocked over
    load the ground through measurably different bodies."""
    betas = torch.zeros((2, 10))
    betas[1, 0], betas[1, 1] = 2.0, -2.0
    bp = bm.from_smpl_npz(FIXTURE, betas, device="cpu")
    assert float((bp.mesh_points[0] - bp.mesh_points[1]).abs().max()) > 0.01
    assert float((bp.mesh_point_radius[0]
                  - bp.mesh_point_radius[1]).abs().max()) > 0.003
    model = build_model(bp)
    terrain = flat_terrain(extent=20.0, cell=0.1, device="cpu")
    st = rest_state(model)
    u = st.u.clone()
    u[:, 3] = 6.0                                   # a hard roll about x
    st = st.replace(u=u)
    cfg = EngineConfig(n_substeps=2, mesh_contacts=True)
    acc = torch.zeros((2, bm.NUM_BODIES))
    for _ in range(30):
        st = step(model, terrain, st, torch.zeros((2, 23, 3)), cfg)
        acc = acc + st.contact_force.norm(dim=-1)
    assert bool(torch.isfinite(acc).all()) and float(acc.sum(-1).min()) > 1.0
    p = acc / acc.sum(-1, keepdim=True)
    assert float((p[0] - p[1]).abs().sum()) > 0.05
