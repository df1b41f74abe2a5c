"""Observation kernels — batched tensor functions.

Port of the parts of emloco_tpu/envs/observations.py the default env and
its training run: the heading-relative self observation, the AMP features,
the trajectory (location) observation, the height-map sensor, the
left/right mirror of the body state, the self observation and the actions
(the motion-symmetry loss), and the AMP dropout mask.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kinematics import body_model as bm
from ..ops import quat
from ..physics.terrain import Heightfield, height_at_min2_xy

_REMOVE = {"L_Hand", "R_Hand", "L_Toe", "R_Toe"}
DOF_SUBSET_JOINTS = np.array(
    [i for i, n in enumerate(bm.BODY_NAMES[1:]) if n not in _REMOVE])
KEY_BODY_IDS = np.array([bm.BODY_NAMES.index(n) for n in bm.KEY_BODIES])
CONTACT_BODY_IDS = np.array([bm.BODY_NAMES.index(n)
                             for n in bm.CONTACT_BODIES])


def _mirror_index():
    """Left-right body permutation: L_x ↔ R_x, the rest fixed."""
    out = []
    for n in bm.BODY_NAMES:
        if n.startswith("L_"):
            out.append(bm.BODY_NAMES.index("R_" + n[2:]))
        elif n.startswith("R_"):
            out.append(bm.BODY_NAMES.index("L_" + n[2:]))
        else:
            out.append(bm.BODY_NAMES.index(n))
    return np.array(out)


MIRROR_BODY = _mirror_index()
MIRROR_ACTION = MIRROR_BODY[1:] - 1  # joint-index permutation

SELF_OBS_DIM = bm.NUM_BODIES * 15 - 3
AMP_OBS_DIM = 6 + 3 + 3 + len(DOF_SUBSET_JOINTS) * 9 + len(KEY_BODY_IDS) * 3

# per-step AMP-obs block offsets (rot 6 + vel 3 + ang_vel 3, no root_h)
_AMP_DOF_OBS_OFFSET = 12
_AMP_DOF_VEL_OFFSET = _AMP_DOF_OBS_OFFSET + len(DOF_SUBSET_JOINTS) * 6


def dof_to_obs(dof_pos: torch.Tensor) -> torch.Tensor:
    """(…, J, 3) exp-map → (…, J*6) tan-norm features."""
    tn = quat.to_tan_norm(quat.exp_map_to_quat(dof_pos))
    return tn.reshape(tn.shape[:-2] + (-1,))


def humanoid_obs_max(body_pos, body_rot, body_vel, body_ang_vel, betas=None,
                     limb_weights=None) -> torch.Tensor:
    """[local body pos (23·3), body rot tan-norm (24·6), body vel (24·3),
    body ang vel (24·3), shape (11)?, limb weights (10)?] for the upright
    asset without the root-height slot (the flagship configuration)."""
    N = body_pos.shape[0]
    root_pos = body_pos[:, 0]
    root_rot = body_rot[:, 0]
    h_exp = quat.heading_quat_inv(root_rot)[:, None]

    local_pos = quat.rotate(h_exp, body_pos - root_pos[:, None])
    local_pos = local_pos[:, 1:].reshape(N, -1)
    local_rot = quat.mul(h_exp.expand(body_rot.shape), body_rot)
    rot_obs = quat.to_tan_norm(local_rot).reshape(N, -1)
    local_vel = quat.rotate(h_exp, body_vel).reshape(N, -1)
    local_ang_vel = quat.rotate(h_exp, body_ang_vel).reshape(N, -1)

    parts = [local_pos, rot_obs, local_vel, local_ang_vel]
    if betas is not None:
        parts.append(betas[:, :11])
    if limb_weights is not None:
        parts.append(limb_weights)
    return torch.cat(parts, dim=-1)


def amp_obs(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
            key_pos, betas=None, limb_weights=None) -> torch.Tensor:
    """[root rot tan-norm (6), local root vel (3), local root ang vel (3),
    dof obs subset (19·6), dof vel subset (19·3), local key body pos (4·3),
    shape (11)?, limb weights (10)?] for the upright asset."""
    N = root_pos.shape[0]
    heading_inv = quat.heading_quat_inv(root_rot)
    root_rot_obs = quat.to_tan_norm(quat.mul(heading_inv, root_rot))
    local_vel = quat.rotate(heading_inv, root_vel)
    local_ang_vel = quat.rotate(heading_inv, root_ang_vel)
    rel_key = key_pos - root_pos[:, None]
    local_key = quat.rotate(heading_inv[:, None], rel_key).reshape(N, -1)

    sel = torch.as_tensor(DOF_SUBSET_JOINTS, device=root_pos.device)
    dof_obs = dof_to_obs(dof_pos[:, sel])
    dvel = dof_vel[:, sel].reshape(N, -1)

    parts = [root_rot_obs, local_vel, local_ang_vel, dof_obs, dvel,
             local_key]
    if betas is not None:
        parts.append(betas[:, :11])
    if limb_weights is not None:
        parts.append(limb_weights)
    return torch.cat(parts, dim=-1)


def amp_dropout_draw(gen: torch.Generator, batch: int,
                     device=None) -> torch.Tensor:
    """The uniform draw behind one AMP dropout mask: (batch, 19), one value
    per observed joint."""
    return torch.rand((batch, len(DOF_SUBSET_JOINTS)), generator=gen,
                      device=device)


def amp_dropout_mask(u: torch.Tensor, steps: int, per_step: int,
                     rate: float = 0.3) -> torch.Tensor:
    """Whole-joint dropout mask for the discriminator's inputs from the draw
    `u` (amp_dropout_draw): joint j is dropped where u[:, j] ≤ rate, zeroing
    both its 6-d tan-norm dof block and its 3-d dof-vel block, with the same
    mask at every window step. Returns (batch, steps·per_step) of {0, 1}."""
    keep = (u > rate).float()
    step_mask = torch.ones((u.shape[0], per_step), device=u.device)
    n = keep.shape[1]
    step_mask[:, _AMP_DOF_OBS_OFFSET:_AMP_DOF_OBS_OFFSET + 6 * n] = \
        keep.repeat_interleave(6, -1)
    step_mask[:, _AMP_DOF_VEL_OFFSET:_AMP_DOF_VEL_OFFSET + 3 * n] = \
        keep.repeat_interleave(3, -1)
    return step_mask.repeat(1, steps)


def location_obs(root_pos, root_rot, traj_samples) -> torch.Tensor:
    """Future trajectory samples in the heading-local frame, xy only:
    traj_samples (N,S,3) → (N,S·2)."""
    heading_inv = quat.heading_quat_inv(root_rot)
    local = quat.rotate(heading_inv[:, None], traj_samples - root_pos[:, None])
    return local[..., :2].reshape(root_pos.shape[0], -1)


def make_sensor_grid(extent: float = 2.0, res: int = 32) -> np.ndarray:
    """(res², 2) local xy grid."""
    lin = np.linspace(-extent, extent, res)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def _rotate_grid_xy(heading, grid, origin_xy):
    """Rotate a static (P,2) grid by per-env heading and translate."""
    c = torch.cos(heading)[:, None]
    s = torch.sin(heading)[:, None]
    gx, gy = grid[:, 0][None], grid[:, 1][None]
    return (c * gx - s * gy + origin_xy[:, 0:1],
            s * gx + c * gy + origin_xy[:, 1:2])


def heightmap_obs(terrain: Heightfield, sensor_pos, sensor_rot, center_xy,
                  grid_local, meas_scale: float = 5.0) -> torch.Tensor:
    """Heading-rotated height grid around the sensor (the head), relative to
    the mean ground height under the root, scaled. Heights use the
    conservative 2-point min lookup."""
    dev = sensor_pos.device
    heading = quat.calc_heading(sensor_rot)
    px, py = _rotate_grid_xy(heading, torch.as_tensor(grid_local, device=dev),
                             sensor_pos[:, :2])
    h = height_at_min2_xy(terrain, px, py)
    cg = torch.as_tensor(make_sensor_grid(0.15, 3), device=dev)
    cpx, cpy = _rotate_grid_xy(heading, cg, center_xy)
    ch = height_at_min2_xy(terrain, cpx, cpy).mean(-1, keepdim=True)
    return torch.clamp(ch - h, -3.0, 3.0) * meas_scale


def flip_body_state(body_pos, body_rot, body_vel, body_ang_vel):
    """Mirror the body state across the xz plane for the motion-symmetry
    loss: positions and velocities negate y, rotations and angular
    velocities (pseudovectors) negate x and z, bodies swap left and right."""
    dev = body_pos.device
    mi = torch.as_tensor(MIRROR_BODY, device=dev)
    vec = torch.tensor([1.0, -1.0, 1.0], device=dev)
    pseudo = torch.tensor([-1.0, 1.0, -1.0], device=dev)
    rot = torch.tensor([-1.0, 1.0, -1.0, 1.0], device=dev)
    return ((body_pos * vec)[:, mi], (body_rot * rot)[:, mi],
            (body_vel * vec)[:, mi], (body_ang_vel * pseudo)[:, mi])


def build_self_obs_flip(self_dim: int):
    """Static (index, sign) realizing the left/right mirror of the self
    observation in feature space: the mirror commutes with the heading-local
    projection, so the flipped state's observation is a signed permutation
    of the unflipped one — body L↔R plus per-component signs (positions and
    velocities negate y, both tan-norm columns (x, −y, z), angular velocity
    negates x and z, betas unchanged, limb-weight groups swap L/R)."""
    B = bm.NUM_BODIES
    mi = MIRROR_BODY
    idx = np.arange(self_dim)
    sign = np.ones(self_dim, np.float32)
    o = 0                        # no root_h slot (rootHeightObs False)
    for b in range(1, B):        # local body pos, bodies 1..23: −y
        src = o + (mi[b] - 1) * 3
        dst = o + (b - 1) * 3
        idx[dst:dst + 3] = np.arange(src, src + 3)
        sign[dst + 1] = -1.0
    o += (B - 1) * 3
    for b in range(B):           # rot tan-norm: M·v = (x, −y, z) per column
        src = o + mi[b] * 6
        dst = o + b * 6
        idx[dst:dst + 6] = np.arange(src, src + 6)
        sign[dst:dst + 6] = [1, -1, 1, 1, -1, 1]
    o += B * 6
    for b in range(B):           # body vel: −y
        src = o + mi[b] * 3
        dst = o + b * 3
        idx[dst:dst + 3] = np.arange(src, src + 3)
        sign[dst + 1] = -1.0
    o += B * 3
    for b in range(B):           # body ang vel (pseudovector): −x, −z
        src = o + mi[b] * 3
        dst = o + b * 3
        idx[dst:dst + 3] = np.arange(src, src + 3)
        sign[dst] = -1.0
        sign[dst + 2] = -1.0
    o += B * 3
    if self_dim > o:             # betas (11) unchanged
        o += 11
    if self_dim > o:             # limb weights: L↔R
        gperm = np.array([1, 0, 2, 4, 3])
        idx[o:o + 5] = o + gperm
        idx[o + 5:o + 10] = o + 5 + gperm
        o += 10
    if o != self_dim:
        raise ValueError(f"self obs of {self_dim} floats has no mirror "
                         f"(layout ends at {o})")
    return idx, sign


def flip_actions(actions: torch.Tensor) -> torch.Tensor:
    """Mirror exp-map actions: joints swap left and right, x and z negate."""
    a = actions.reshape(actions.shape[0], bm.NUM_JOINTS, 3)
    a = a[:, torch.as_tensor(MIRROR_ACTION, device=a.device)]
    a = a * torch.tensor([-1.0, 1.0, -1.0], device=a.device)
    return a.reshape(actions.shape[0], -1)
