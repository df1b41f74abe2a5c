"""Trajectory generation — procedural random walks and real-path banks.

Port of emloco_tpu/envs/traj_gen.py: trajectories are (V, 3) vertex chains
per env, resampled on the device at reset; queries interpolate linearly
along the chain. Random draws come from a torch.Generator.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import device as _device
from ..parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class TrajConfig:
    num_verts: int = 101
    episode_dur: float = 10.0
    speed_min: float = 0.0005
    speed_max: float = 3.0
    accel_max: float = 2.0
    dtheta_max: float = 2.0
    sharp_turn_prob: float = 0.02
    # probability of a procedural trajectory when a real bank exists
    hybrid_init_prob: float = 0.5
    adjust_root_vel: bool = True
    init_heading: bool = True
    # fraction of real paths flipped 180° as LocoVal hard negatives
    heading_inversion_prob: float = 0.0
    # procedural paths straight at the mean speed; at a quarter speed
    fixed_path: bool = False
    slow: bool = False

    @property
    def dt(self):
        return self.episode_dur / (self.num_verts - 1)


def _uniform(gen, shape, device, mesh=None):
    """Uniform draws; with `mesh`, shape[0] is this rank's envs and the draw
    the whole env axis's (parallel.mesh.draw_rows)."""
    return pmesh.draw_rows(torch.rand, shape, mesh, generator=gen,
                           device=device)


def procedural_verts(gen, n, cfg: TrajConfig, init_pos, root_vel=None,
                     mesh=None):
    """Random-walk trajectories; init_pos (n,3) → verts (n, V, 3) with
    verts[:, 0, :2] = init xy (`mesh` as in _uniform)."""
    dev = init_pos.device
    V = cfg.num_verts
    dtheta = (2 * _uniform(gen, (n, V - 1), dev, mesh) - 1) \
        * cfg.dtheta_max * cfg.dt
    sharp = _uniform(gen, (n, V - 1), dev, mesh) < cfg.sharp_turn_prob
    dtheta_sharp = math.pi * (2 * _uniform(gen, (n, V - 1), dev, mesh) - 1)
    dtheta = torch.where(sharp, dtheta_sharp, dtheta)
    dtheta[:, 0] = math.pi * (2 * _uniform(gen, (n,), dev, mesh) - 1)

    dspeed = (2 * _uniform(gen, (n, V - 1), dev, mesh) - 1) \
        * cfg.accel_max * cfg.dt
    speed0 = (_uniform(gen, (n,), dev, mesh)
              * (cfg.speed_max - cfg.speed_min) + cfg.speed_min)
    speeds = [speed0]
    s = speed0
    for i in range(1, V - 1):
        s = torch.clamp(s + dspeed[:, i], cfg.speed_min, cfg.speed_max)
        speeds.append(s)
    speed = torch.stack(speeds, dim=1)                    # (n, V-1)

    if cfg.fixed_path:
        dtheta = torch.zeros_like(dtheta)
        speed = torch.full_like(speed, (cfg.speed_min + cfg.speed_max) / 2)
    if cfg.slow:
        speed = speed / 4

    if cfg.adjust_root_vel and root_vel is not None:
        root_speed = torch.linalg.norm(root_vel[:, :2], dim=-1)
        ratio = root_speed / torch.clamp(speed[:, 0], min=1e-6)
        speed = torch.clamp(speed * ratio[:, None], cfg.speed_min,
                            cfg.speed_max)

    theta = torch.cumsum(dtheta, dim=-1)
    seg = speed * cfg.dt
    dpos = torch.stack([torch.cos(theta), -torch.sin(theta),
                        torch.zeros_like(theta)], -1) * seg[..., None]
    dpos[:, 0, 0:2] = dpos[:, 0, 0:2] + init_pos[:, 0:2]
    verts = torch.cumsum(dpos, dim=-2)
    first = torch.cat([init_pos[:, :2], torch.zeros_like(init_pos[:, :1])],
                      -1)
    return torch.cat([first[:, None], verts], dim=1)


def align_real_paths(paths, init_pos, root_vel=None, init_heading=True,
                     invert=None):
    """Shift bank samples (n, V, 2) to start at init_pos and rotate their
    first segment to the root's heading (opposite it where `invert`)."""
    p = paths - paths[:, 0:1]
    if init_heading and root_vel is not None:
        tgt = torch.atan2(root_vel[:, 1], root_vel[:, 0])
        if invert is not None:
            tgt = tgt + torch.where(invert, math.pi, 0.0)
        d0 = p[:, 1] - p[:, 0]
        a = tgt - torch.atan2(d0[..., 1], d0[..., 0])
        ca, sa = torch.cos(a), torch.sin(a)
        rot = torch.stack([torch.stack([ca, -sa], -1),
                           torch.stack([sa, ca], -1)], -2)
        p = torch.einsum("nij,nvj->nvi", rot, p)
    return p + init_pos[:, None, :2]


def sample_traj(gen, cfg: TrajConfig, init_pos, root_vel=None,
                real_bank=None, mesh=None):
    """Full reset: procedural or real-bank trajectory per env. Returns
    (verts (n,V,3), inverted (n,) bool); `mesh` as in _uniform."""
    n = init_pos.shape[0]
    dev = init_pos.device
    verts = procedural_verts(gen, n, cfg, init_pos, root_vel, mesh)
    inverted = torch.zeros((n,), dtype=torch.bool, device=dev)
    if real_bank is None and cfg.heading_inversion_prob > 0.0:
        raise ValueError("heading_inversion_prob > 0 requires a real "
                         "trajectory bank")
    if real_bank is not None:
        idx = pmesh.draw_rows(torch.randint, (n,), mesh, 0,
                              real_bank.shape[0], generator=gen, device=dev)
        picked = real_bank[idx]
        do_inv = cfg.init_heading and root_vel is not None
        if cfg.heading_inversion_prob > 0.0 and not do_inv:
            raise ValueError("heading_inversion_prob > 0 requires "
                             "traj.init_heading=True and a root velocity")
        inv = (_uniform(gen, (n,), dev, mesh)
               < cfg.heading_inversion_prob) & do_inv
        aligned = align_real_paths(picked, init_pos, root_vel,
                                   cfg.init_heading, invert=inv)
        aligned3 = torch.cat([aligned, torch.zeros_like(aligned[..., :1])],
                             -1)
        use_real = (_uniform(gen, (n,), dev, mesh)
                    >= cfg.hybrid_init_prob)
        verts = torch.where(use_real[:, None, None], aligned3, verts)
        inverted = use_real & inv
    return verts, inverted


def _interp(verts, times, episode_dur):
    """Vertex-chain lerp at times (n, ...) → (n, ..., 3)."""
    V = verts.shape[1]
    n = times.shape[0]
    phase = torch.clamp(times / episode_dur, 0.0, 1.0)
    seg = phase * (V - 1)
    i0 = torch.clamp(torch.floor(seg).long(), 0, V - 2)
    f = (seg - i0).reshape(n, -1, 1)
    idx = i0.reshape(n, -1, 1).expand(-1, -1, 3)
    a = torch.gather(verts, 1, idx)
    b = torch.gather(verts, 1, idx + 1)
    return ((1.0 - f) * a + f * b).reshape(times.shape + (3,))


def calc_pos(verts, times, episode_dur):
    """verts (n,V,3), times (n,) seconds → (n,3)."""
    return _interp(verts, times, episode_dur)


def fetch_samples(verts, times, episode_dur, num_samples, sample_dt):
    """Future waypoints at fixed time offsets → (n, S, 3)."""
    offsets = torch.arange(num_samples, device=times.device) * sample_dt
    return _interp(verts, times[:, None] + offsets[None], episode_dur)


def synthetic_real_bank(num_paths=256, num_verts=101, seed=0, device=None):
    """Stand-in 'real path' bank with pedestrian-like statistics (P, V, 2),
    the same paths as the JAX package's generator for the same seed."""
    dev = _device.resolve(device)
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 1, num_verts)
    paths = []
    for _ in range(num_paths):
        speed = rng.uniform(0.5, 2.2)
        curv = rng.normal(0, 0.3)
        wob = rng.normal(0, 0.05, 3)
        theta = curv * t * 2 * np.pi * 0.2 + \
            wob[0] * np.sin(2 * np.pi * t * rng.uniform(1, 3))
        x = np.cumsum(np.cos(theta)) * speed * 10.0 / num_verts
        y = np.cumsum(np.sin(theta)) * speed * 10.0 / num_verts
        paths.append(np.stack([x, y], -1))
    return torch.as_tensor(np.stack(paths), dtype=torch.float32, device=dev)
