"""Pedestrian scenes for the trajectory predictor, made on the device from
the seed, at the JTA loader's shapes (Social-Transmotion's JTA pipeline:
9 observed and 12 future frames at 2.5 fps, people padded to a fixed
count, tokens of (trajectory, 3D box, 2D box, 24 3D joints, 22 2D joints)
× 4 channels).

Every person walks at a speed U(0.5, 2) m/s on a heading that turns at a
rate N(0, 0.2²) rad/s from a start U(−5, 5) m; the 3D pose is a standing
skeleton turned to the heading with a gait's swing of the legs and arms
and N(0, 0.01²) m of jitter; the boxes and the 2D pose follow from it
(2D = 50·xy + 500). Each scene has U{lo..N} people present (person 0, the
primary, always), the rest zero and masked. Then the reference pipeline's
normalization: trajectories less the primary's last observed position,
boxes and poses less their own last observed value; the EmLoco inputs are
the primary's raw pose at the last observed frame (z down, as JTA stores
it) and its velocity (x₈ − x₇)·2.5.
"""
from __future__ import annotations

import math

import torch

OBS, TOTAL, FPS = 9, 21, 2.5
J3, J2 = 24, 22
J = 3 + J3 + J2

# a standing SMPL-order skeleton, root-relative, metres (x forward, y left,
# z up): pelvis, legs, spine to head, arms
_SKELETON = (
    (0.0, 0.0, 0.0), (0.0, 0.09, -0.09), (0.0, 0.11, -0.48),
    (0.0, 0.11, -0.88), (0.12, 0.12, -0.94), (0.0, -0.09, -0.09),
    (0.0, -0.11, -0.48), (0.0, -0.11, -0.88), (0.12, -0.12, -0.94),
    (0.0, 0.0, 0.11), (0.0, 0.0, 0.24), (0.0, 0.0, 0.30), (0.0, 0.0, 0.50),
    (0.02, 0.0, 0.60), (0.0, 0.08, 0.40), (0.0, 0.18, 0.40),
    (0.0, 0.43, 0.40), (0.0, 0.68, 0.40), (0.0, 0.76, 0.40),
    (0.0, -0.08, 0.40), (0.0, -0.18, 0.40), (0.0, -0.43, 0.40),
    (0.0, -0.68, 0.40), (0.0, -0.76, 0.40))
_SWING = (0, 1, 1, 1, 1, -1, -1, -1, -1, 0, 0, 0, 0, 0, 0, 0, -1, -1, -1,
          0, 0, 1, 1, 1)


def bank(num_batches: int, batch: int, people: int, min_people: int,
         seed: int, device) -> list:
    """`num_batches` batches (obs, present, gt_future, init_pose, init_vel)
    of `batch` scenes, on `device`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    S, N, dev = num_batches * batch, people, device

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    t = torch.arange(TOTAL, device=dev) / FPS                  # (T,)
    speed = u(S, N, lo=0.5, hi=2.0)
    head0 = u(S, N, lo=-math.pi, hi=math.pi)
    turn = torch.randn((S, N), generator=g, device=dev) * 0.2
    heading = head0[..., None] + turn[..., None] * t            # (S,N,T)
    step = torch.stack([torch.cos(heading), torch.sin(heading)], -1)
    xy = torch.cumsum(step * speed[..., None, None] / FPS, 2)
    xy = xy + u(S, N, 1, 2, lo=-5.0, hi=5.0)
    xy = xy.permute(0, 2, 1, 3)                                 # (S,T,N,2)
    heading = heading.permute(0, 2, 1)                          # (S,T,N)

    sk = torch.tensor(_SKELETON, device=dev)                    # (24,3)
    phase = u(S, N, hi=2 * math.pi)[:, None] + 2 * math.pi * t[None, :,
                                                               None]
    swing = 0.25 * torch.sin(phase)[..., None] * torch.tensor(
        _SWING, dtype=torch.float32, device=dev)                # (S,T,N,24)
    local = sk.expand(S, TOTAL, N, J3, 3).clone()
    local[..., 0] = local[..., 0] + swing
    local = local + torch.randn(local.shape, generator=g, device=dev) * 0.01
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    pose = torch.stack([c * local[..., 0] - s * local[..., 1],
                        s * local[..., 0] + c * local[..., 1],
                        local[..., 2]], -1)                     # (S,T,N,24,3)
    pose_raw = pose * torch.tensor([1.0, 1.0, -1.0], device=dev)
    px = pose[..., :J2, :2] * 50 + 500
    box2 = torch.cat([px.amin(-2), px.amax(-2) - px.amin(-2)], -1)
    box3 = torch.stack([torch.full_like(heading, 1.8),
                        torch.full_like(heading, 0.6),
                        torch.full_like(heading, 0.5), heading], -1)

    tok = torch.zeros((S, TOTAL, N, J, 4), device=dev)
    tok[..., 0, :2] = xy
    tok[..., 1, :4] = box3
    tok[..., 2, :4] = box2
    tok[..., 3:3 + J3, :3] = pose_raw
    tok[..., 3 + J3:, :2] = px
    count = torch.randint(min_people, N + 1, (S,), generator=g, device=dev)
    present = torch.arange(N, device=dev)[None] < count[:, None]  # (S,N)
    tok = tok * present[:, None, :, None, None]

    init_pose = tok[:, OBS - 1, 0, 3:3 + J3, :3].clone()
    init_vel = (tok[:, OBS - 1, 0, 0, :2] - tok[:, OBS - 2, 0, 0, :2]) * FPS
    ref = tok[:, OBS - 1:OBS].clone()
    tok[..., 0, :2] -= ref[:, :, 0:1, 0, :2]
    tok[:, :, :, 1:3] -= ref[:, :, :, 1:3]
    tok[:, :, :, 3:] -= ref[:, :, :, 3:]
    tok = tok * present[:, None, :, None, None]
    obs = tok[:, :OBS].contiguous()
    gt = tok[:, OBS:, 0, 0, :2].contiguous()
    out = []
    for i in range(num_batches):
        sl = slice(i * batch, (i + 1) * batch)
        out.append((obs[sl], present[sl], gt[sl], init_pose[sl],
                    init_vel[sl]))
    return out
