"""Physical oracles of the port's engine on its own, over long rollouts.

Ports of the oracles of tests/test_engine.py (freefall, standing, weight on
ground, PD tracking, gravity sag, joint limits, no penetration, violent
impacts, torque saturation) with the JAX tests' own setups, lengths and
thresholds, run on the port alone on the CPU at 1-4 envs: nothing else
checks the port's rollouts beyond three steps. Standing and weight on ground
also run under `gram_kernel=True`, whose LHS comes from the gram_diag
kernel's plain version here.
"""
import numpy as np
import pytest
import torch

from emloco_tpu_torch.kinematics import body_model as bm
from emloco_tpu_torch.ops import quat
from emloco_tpu_torch.physics import (EngineConfig, build_model,
                                      default_tree, flat_terrain,
                                      joint_state, kinematic_state, step)

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
