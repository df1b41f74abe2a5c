"""Observation kernels — batched tensor functions.

Port of emloco_tpu/envs/observations.py: the heading-relative self
observation, the AMP features, the trajectory (location) observation, the
height-map sensor on its three footprints (square, forward fan, forward
square) and its 3-channel velocity-map variant, the crowd observation of
the nearest people in an env's group and the velocity map with those people
stamped in, the left/right mirror of the body state, the self observation,
the sensor grid and the actions (the motion-symmetry loss), and the AMP
dropout mask. The self, AMP, location and crowd observations take the
optional root-height slot and the non-upright asset's base rotation
(remove_base_rot) as the JAX functions do. The crowd observation and the
velocity-map sensor are the program's spans `env.group_obs` and
`env.velocity_map` (utils/profiling.annotate), and count their calls and
rows on the host (`CROWD_COUNTS`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kinematics import body_model as bm
from ..ops import quat
from ..physics.terrain import Heightfield, height_at_min2_xy
from ..utils.profiling import annotate

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


def remove_base_rot(q: torch.Tensor) -> torch.Tensor:
    """Strip the SMPL base rotation of a non-upright asset: q ∘ conj(base),
    base = (½, ½, ½, ½). The product with the fixed (−½, −½, −½, ½) is
    written out as sums and differences of q's components, in the order of
    quat.mul's terms, so no constant is copied to the device."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return 0.5 * torch.stack([((x - w) - y) + z, ((x - w) + y) - z,
                              ((-w - x) + y) + z, ((w + x) + y) + z], -1)


def dof_to_obs(dof_pos: torch.Tensor) -> torch.Tensor:
    """(…, J, 3) exp-map → (…, J*6) tan-norm features."""
    tn = quat.to_tan_norm(quat.exp_map_to_quat(dof_pos))
    return tn.reshape(tn.shape[:-2] + (-1,))


def humanoid_obs_max(body_pos, body_rot, body_vel, body_ang_vel, betas=None,
                     limb_weights=None, root_height_obs: bool = False,
                     upright: bool = True) -> torch.Tensor:
    """[root height (1)?, local body pos (23·3), body rot tan-norm (24·6),
    body vel (24·3), body ang vel (24·3), shape (11)?, limb weights (10)?]
    in the heading frame. The flagship configuration is the default: no
    root-height slot, an upright asset; a non-upright asset's heading is
    taken after remove_base_rot."""
    N = body_pos.shape[0]
    root_pos = body_pos[:, 0]
    root_rot = body_rot[:, 0]
    if not upright:
        root_rot = remove_base_rot(root_rot)
    h_exp = quat.heading_quat_inv(root_rot)[:, None]

    local_pos = quat.rotate(h_exp, body_pos - root_pos[:, None])
    local_pos = local_pos[:, 1:].reshape(N, -1)
    local_rot = quat.mul(h_exp.expand(body_rot.shape), body_rot)
    rot_obs = quat.to_tan_norm(local_rot).reshape(N, -1)
    local_vel = quat.rotate(h_exp, body_vel).reshape(N, -1)
    local_ang_vel = quat.rotate(h_exp, body_ang_vel).reshape(N, -1)

    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [local_pos, rot_obs, local_vel, local_ang_vel]
    if betas is not None:
        parts.append(betas[:, :11])
    if limb_weights is not None:
        parts.append(limb_weights)
    return torch.cat(parts, dim=-1)


def amp_obs(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
            key_pos, betas=None, limb_weights=None,
            root_height_obs: bool = False,
            upright: bool = True) -> torch.Tensor:
    """[root height (1)?, root rot tan-norm (6), local root vel (3), local
    root ang vel (3), dof obs subset (19·6), dof vel subset (19·3), local
    key body pos (4·3), shape (11)?, limb weights (10)?]. A non-upright
    asset's root rotation goes through remove_base_rot first. The dropout
    mask's offsets (_AMP_DOF_OBS_OFFSET) assume no root-height slot, as the
    JAX package's do."""
    N = root_pos.shape[0]
    if not upright:
        root_rot = remove_base_rot(root_rot)
    heading_inv = quat.heading_quat_inv(root_rot)
    root_rot_obs = quat.to_tan_norm(quat.mul(heading_inv, root_rot))
    local_vel = quat.rotate(heading_inv, root_vel)
    local_ang_vel = quat.rotate(heading_inv, root_ang_vel)
    rel_key = key_pos - root_pos[:, None]
    local_key = quat.rotate(heading_inv[:, None], rel_key).reshape(N, -1)

    sel = torch.as_tensor(DOF_SUBSET_JOINTS, device=root_pos.device)
    dof_obs = dof_to_obs(dof_pos[:, sel])
    dvel = dof_vel[:, sel].reshape(N, -1)

    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [root_rot_obs, local_vel, local_ang_vel, dof_obs, dvel,
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


def location_obs(root_pos, root_rot, traj_samples,
                 upright: bool = True) -> torch.Tensor:
    """Future trajectory samples in the heading-local frame, xy only:
    traj_samples (N,S,3) → (N,S·2). A non-upright asset's root rotation
    goes through remove_base_rot first."""
    if not upright:
        root_rot = remove_base_rot(root_rot)
    heading_inv = quat.heading_quat_inv(root_rot)
    local = quat.rotate(heading_inv[:, None], traj_samples - root_pos[:, None])
    return local[..., :2].reshape(root_pos.shape[0], -1)


def make_sensor_grid(extent: float = 2.0, res: int = 32) -> np.ndarray:
    """(res², 2) local xy grid."""
    lin = np.linspace(-extent, extent, res)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def make_sensor_grid_fov(max_range: float = 2.0,
                         max_angle_deg: float = 110.0) -> np.ndarray:
    """(450, 2) forward fan: 18 exponentially spaced ranges × 25
    exponentially spaced bearings mirrored around +x."""
    rs = np.exp(np.arange(0.2, 2, 0.1)) - 0.9
    rs = rs / rs.max() * max_range
    phi = np.exp(np.linspace(0.1, 1.5, 12)) - 1
    phi = phi / phi.max() * max_angle_deg
    phi = np.concatenate([-phi[::-1], [0], phi]) * np.pi / 180
    r, p = np.meshgrid(rs, phi, indexing="ij")
    return np.stack([(r * np.cos(p)).ravel(),
                     (r * np.sin(p)).ravel()], -1).astype(np.float32)


def make_sensor_grid_square_fov(res: int = 20) -> np.ndarray:
    """(res², 2) forward square: x ∈ [−0.02, 1.98], y ∈ [−1, 1]."""
    x = np.linspace(-0.02, 1.98, res)
    y = np.linspace(-1, 1, res)
    gx, gy = np.meshgrid(x, y, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


# sensor_shape → grid from (extent, res); the fan and the forward square
# ignore the resolution, the forward square the extent too
SENSOR_GRIDS = {
    "square": lambda extent, res: make_sensor_grid(extent, res),
    "fov": lambda extent, res: make_sensor_grid_fov(extent),
    "square_fov": lambda extent, res: make_sensor_grid_square_fov(),
}


def grid_flip_perm(grid: np.ndarray) -> np.ndarray:
    """Index permutation realizing the y-mirror of a sensor grid: point i
    maps to the grid point nearest (x_i, −y_i). Every sensor shape is
    y-symmetric, so the permutation is an involution; a grid that is not
    raises ValueError."""
    flipped = grid * np.array([1.0, -1.0], np.float32)
    d = np.linalg.norm(flipped[:, None] - grid[None], axis=-1)
    perm = d.argmin(-1)
    if not (perm[perm] == np.arange(len(grid))).all():
        raise ValueError("sensor grid is not y-symmetric")
    return perm


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


GROUP_JOINTS = np.array([0, 1, 5, 9, 3, 7, 16, 21, 18, 23])

# calls and rows of the crowd observation (`group_obs`) and of the
# velocity-map sensor (`group_velocity_map_obs`, `velocity_map_obs`) since
# the last reset, counted on the host from shapes (no device sync)
CROWD_COUNTS = {"group_obs_calls": 0, "group_obs_rows": 0,
                "velocity_map_calls": 0, "velocity_map_rows": 0}


def reset_crowd_counts():
    for k in CROWD_COUNTS:
        CROWD_COUNTS[k] = 0


def _count(part: str, rows: int):
    CROWD_COUNTS[part + "_calls"] += 1
    CROWD_COUNTS[part + "_rows"] += rows


def check_group_shards(num_envs: int, group_size: int, ranks: int):
    """The crowd observation sees the other envs of an env's group, so an
    env axis split over `ranks` must split on group boundaries: raises
    ValueError unless each rank's num_envs / ranks envs are whole groups."""
    per = num_envs // ranks
    if num_envs % ranks or per % group_size:
        raise ValueError(
            f"group_obs over a {ranks}-rank mesh needs each rank's envs to "
            f"be whole groups: num_envs={num_envs} / {ranks} ranks = "
            f"{num_envs / ranks:g} envs a rank, group_size={group_size}")


def _nearest_in_group(xy, group_size: int, k: int):
    """Each env's k nearest others in its group of `group_size` consecutive
    envs, nearest first: (distances (N, k), flat env indices (N, k)). The
    distance is the norm of the differences with 1e9 added on the diagonal,
    as the JAX package computes it, so that near-ties order alike."""
    N, D = xy.shape
    G = N // group_size
    gp = xy.reshape(G, group_size, D)
    dist = torch.linalg.norm(gp[:, :, None] - gp[:, None], dim=-1)
    dist = dist + torch.eye(group_size, device=xy.device)[None] * 1e9
    nd, idx = torch.topk(dist, k, dim=-1, largest=False, sorted=True)
    base = torch.arange(G, device=xy.device)[:, None, None] * group_size
    return nd.reshape(N, k), (idx + base).reshape(N, k)


def group_obs(body_pos, body_vel, root_rot, group_size: int, top_k: int = 5,
              max_dist: float = 10.0, upright: bool = True) -> torch.Tensor:
    """Crowd observation: heading-local positions of the 10 GROUP_JOINTS of
    the top-k nearest people in the env's group, then their root
    velocities; neighbours beyond max_dist are zeroed, and a group too
    small for k neighbours pads with zeros. Layout: the whole k-neighbour
    position block (k·10·3), then the k root velocities (k·3). A
    non-upright asset's root rotation goes through remove_base_rot
    first."""
    with annotate("env.group_obs"):
        _count("group_obs", body_pos.shape[0])
        N = body_pos.shape[0]
        J = len(GROUP_JOINTS)
        root_pos = body_pos[:, 0]
        if not upright:
            root_rot = remove_base_rot(root_rot)
        heading_inv = quat.heading_quat_inv(root_rot)
        k = min(top_k, group_size - 1)
        nd, flat = _nearest_in_group(root_pos, group_size, k)
        flat = flat.reshape(-1)
        sel = torch.as_tensor(GROUP_JOINTS, device=body_pos.device)
        sel_pos = body_pos[flat][:, sel]                   # (N·k, 10, 3)
        sel_vel = body_vel[flat][:, 0:1]                   # (N·k, 1, 3)
        h_rep = heading_inv.repeat_interleave(k, 0)[:, None]
        local_pos = quat.rotate(h_rep, sel_pos
                                - root_pos.repeat_interleave(k, 0)[:, None])
        local_vel = quat.rotate(h_rep, sel_vel)
        near = (nd.reshape(-1) <= max_dist)[:, None, None]
        pos_blk = (local_pos * near).reshape(N, k * J * 3)
        vel_blk = (local_vel * near).reshape(N, k * 3)
        pad = top_k - k
        return torch.cat([pos_blk, body_pos.new_zeros((N, pad * J * 3)),
                          vel_blk, body_pos.new_zeros((N, pad * 3))], -1)


def velocity_map_obs(terrain, sensor_pos, sensor_rot, center_xy, grid_local,
                     root_vel, meas_scale: float = 5.0) -> torch.Tensor:
    """3-channel sensor [relative height, velocity field in the agent's
    frame] with no other people stamped: the field is zero, so every point
    reads −ego velocity in the heading frame. → (N, P·3), channel
    innermost."""
    with annotate("env.velocity_map"):
        _count("velocity_map", sensor_pos.shape[0])
        h = heightmap_obs(terrain, sensor_pos, sensor_rot, center_xy,
                          grid_local, meas_scale)
        v_local = quat.rotate(quat.heading_quat_inv(sensor_rot), root_vel)
        P = h.shape[-1]
        vx = (-v_local[:, 0:1]).expand(-1, P)
        vy = (-v_local[:, 1:2]).expand(-1, P)
        return torch.stack([h, vx, vy], -1).reshape(h.shape[0], -1)


def group_velocity_map_obs(terrain, sensor_pos, sensor_rot, center_xy,
                           grid_local, root_pos, root_vel, group_size: int,
                           meas_scale: float = 5.0, top_k: int = 5,
                           person_height: float = 1.7,
                           footprint=(0.25, 0.5),
                           max_dist: float = 10.0) -> torch.Tensor:
    """Velocity-map sensor with the other people of the env's group stamped
    in: each sensor point tests the world-axis footprint boxes around its
    top-k nearest neighbours' roots (an (N, P, k) test); a covered point
    reads the terrain +person_height and the nearest covering neighbour's
    world velocity. Points then read [ch − h, v − v_ego] in the heading
    frame; the observer is not stamped. → (N, P·3)."""
    with annotate("env.velocity_map"):
        _count("velocity_map", root_pos.shape[0])
        N = root_pos.shape[0]
        dev = root_pos.device
        heading = quat.calc_heading(sensor_rot)
        px, py = _rotate_grid_xy(heading,
                                 torch.as_tensor(grid_local, device=dev),
                                 sensor_pos[:, :2])
        h = height_at_min2_xy(terrain, px, py)             # (N, P)

        k = min(top_k, group_size - 1)
        nd, flat = _nearest_in_group(root_pos[:, :2], group_size, k)
        nbr_xy = root_pos[flat.reshape(-1), :2].reshape(N, k, 2)
        nbr_v = root_vel[flat.reshape(-1)].reshape(N, k, 3)
        near = nd <= max_dist                              # (N, k)

        dx = px[:, :, None] - nbr_xy[:, None, :, 0]
        dy = py[:, :, None] - nbr_xy[:, None, :, 1]
        inside = ((torch.abs(dx) <= footprint[0])
                  & (torch.abs(dy) <= footprint[1]) & near[:, None])
        covered = inside.any(-1)
        d2 = torch.where(inside, dx ** 2 + dy ** 2, torch.inf)
        j = d2.argmin(-1)                                  # (N, P)
        v_cell = nbr_v[torch.arange(N, device=dev)[:, None], j, :2]
        v_cell = torch.where(covered[..., None], v_cell, 0.0)
        h = h + person_height * covered

        cg = torch.as_tensor(make_sensor_grid(0.15, 3), device=dev)
        cpx, cpy = _rotate_grid_xy(heading, cg, center_xy)
        ch = height_at_min2_xy(terrain, cpx, cpy).mean(-1, keepdim=True)
        h_obs = torch.clamp(ch - h, -3.0, 3.0) * meas_scale

        v_rel = v_cell - root_vel[:, None, :2]
        c = torch.cos(-heading)[:, None]
        s = torch.sin(-heading)[:, None]
        vx = c * v_rel[..., 0] - s * v_rel[..., 1]
        vy = s * v_rel[..., 0] + c * v_rel[..., 1]
        return torch.stack([h_obs, vx, vy], -1).reshape(N, -1)


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


@functools.lru_cache(maxsize=None)
def _action_mirror(device: torch.device):
    """flip_actions' joint permutation and signs on `device`, uploaded once
    (no host-to-device copy a call, so the loss it serves can be captured
    as a CUDA graph)."""
    return (torch.as_tensor(MIRROR_ACTION, device=device),
            torch.tensor([-1.0, 1.0, -1.0], device=device))


def flip_actions(actions: torch.Tensor) -> torch.Tensor:
    """Mirror exp-map actions: joints swap left and right, x and z negate."""
    perm, sign = _action_mirror(actions.device)
    a = actions.reshape(actions.shape[0], bm.NUM_JOINTS, 3)
    a = a[:, perm] * sign
    return a.reshape(actions.shape)
