"""Standalone LocoVal probe: score, rank and optimize trajectories (port of
emloco_tpu/analysis/plausibility.py).

Counterpart of the reference's plausibl/test_value_mlp.py (:24-297):
  * score procedurally generated or user trajectories with a trained value
    net (no simulator in the loop);
  * rank a candidate set by plausibility (:196-237);
  * test-time trajectory optimization: Adam on the trajectory coordinates
    against exp(−value) with the value net frozen (:239-274), optax's
    adam(lr) written out, the gradient from torch.autograd.grad.

`params` is ValuePoseNet's state_dict, run through
torch.func.functional_call (flax's vnet.apply). The animation of an
optimization (`animate_optimization`, matplotlib) is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..envs import traj_gen
from ..learning.amp_agent import AdamState, adam_directions
from ..learning.networks import ValuePoseNet


def score_trajectories(vnet: ValuePoseNet, params: dict, trajs,
                       init_pose=None, init_vel=None):
    """trajs (B, W, 2) → plausibility values (B,)."""
    return functional_call(vnet, params, (trajs, init_pose, init_vel))


def rank_trajectories(vnet: ValuePoseNet, params: dict, trajs,
                      init_pose=None, init_vel=None):
    """(order, values) as numpy, order sorted most → least plausible."""
    with torch.no_grad():
        v = score_trajectories(vnet, params, trajs, init_pose,
                               init_vel).cpu().numpy()
    return np.argsort(-v), v


def sample_candidate_trajs(gen: torch.Generator, num: int,
                           num_waypoints: int = 13, dt: float = 0.4,
                           cfg: Optional[traj_gen.TrajConfig] = None):
    """Procedural candidates from the sim's trajectory generator, drawn from
    `gen` on its device and resampled at the prediction waypoint spacing,
    shifted to start at the origin: (num, num_waypoints, 2) (the reference's
    Traj wrapper over TrajGenerator, test_value_mlp.py:116-208)."""
    cfg = cfg or traj_gen.TrajConfig()
    init = torch.zeros((num, 3), device=gen.device)
    verts, _ = traj_gen.sample_traj(gen, cfg, init)
    times = torch.zeros((num,), device=gen.device)
    wp = traj_gen.fetch_samples(verts, times, cfg.episode_dur,
                                num_waypoints, dt)[..., :2]
    return wp - wp[:, 0:1]


def optimize_trajectory(vnet: ValuePoseNet, params: dict, traj0,
                        init_pose=None, init_vel=None, steps: int = 200,
                        lr: float = 0.01, freeze_first: bool = True,
                        record_trajs: bool = False):
    """Gradient-based test-time optimization of trajectory coordinates
    against mean(exp(−value)) (reference test_value_mlp.py:239-274).

    Returns (optimized traj (B, W, 2), values before each step and after
    the last (steps + 1, B)); with `record_trajs` also the trajectory
    before each step and after the last (steps + 1, B, W, 2). With
    `freeze_first`, waypoint 0's gradient is zeroed before Adam, so the
    origin stays bit-equal."""
    params = {k: v.detach() for k, v in params.items()}
    traj = traj0.detach().clone()
    state = AdamState.zeros_like({"traj": traj})
    values, snaps = [], []
    for _ in range(steps):
        x = traj.requires_grad_()
        with torch.enable_grad():
            v = score_trajectories(vnet, params, x, init_pose, init_vel)
            g, = torch.autograd.grad(torch.mean(torch.exp(-v)), x)
        traj = x.detach()
        if freeze_first:
            g[:, 0] = 0.0                     # the origin stays pinned
        state, u = adam_directions({"traj": g}, state)
        values.append(v.detach())
        if record_trajs:
            snaps.append(traj)
        traj = traj + -lr * u["traj"]
    with torch.no_grad():
        values.append(score_trajectories(vnet, params, traj, init_pose,
                                         init_vel))
    values = torch.stack(values)
    if record_trajs:
        return traj, values, torch.stack(snaps + [traj])
    return traj, values
