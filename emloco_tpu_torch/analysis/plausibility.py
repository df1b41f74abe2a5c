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
torch.func.functional_call (flax's vnet.apply). `animate_optimization`
draws a recorded optimization as a GIF with matplotlib, imported inside it.
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


def animate_optimization(snapshots, values, out_path: str = "traj_opt.gif",
                         index: int = 0, fps: int = 10, stride: int = 5):
    """A GIF of trajectory `index` while it is optimized (reference
    test_value_mlp.py:276-297): the trajectory every `stride` steps and
    after the last, its LocoVal value in the title. snapshots (S, B, W, 2)
    and values (S, B), tensors or arrays, as optimize_trajectory returns
    them with record_trajs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    snaps = np.asarray(torch.as_tensor(snapshots).cpu())[:, index]
    vals = np.asarray(torch.as_tensor(values).cpu())[:, index]
    frames = list(range(0, len(snaps), stride)) + [len(snaps) - 1]
    lo = snaps.min((0, 1)) - 0.5
    hi = snaps.max((0, 1)) + 0.5
    fig, ax = plt.subplots(figsize=(5, 5))

    def draw(i):
        t = frames[i]
        ax.cla()
        ax.plot(snaps[0, :, 0], snaps[0, :, 1], ":", c="gray",
                label="initial")
        ax.plot(snaps[t, :, 0], snaps[t, :, 1], "o-", c="tab:blue",
                label="current")
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_aspect("equal")
        ax.set_title(f"step {t}  value={vals[t]:.3f}")
        ax.legend(loc="upper right", fontsize=8)

    anim = animation.FuncAnimation(fig, draw, frames=len(frames),
                                   interval=1000 / fps)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
