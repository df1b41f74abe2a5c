"""Skeleton and rollout plots (port of emloco_tpu/kinematics/visualization.py;
counterpart of poselib's plotters and the reference's rollout videos with
reward overlays, base_task.py:799-844).

numpy and matplotlib on the host. matplotlib is imported inside each
function, so the module imports without it; a call without matplotlib
raises ImportError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import body_model as bm


def _bones(tree):
    return [(int(tree.parents[j]), j) for j in range(1, tree.num_joints)]


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_skeleton_state(ax, joint_pos: np.ndarray, tree=None,
                        color="tab:blue"):
    """joint_pos (J, 3) world positions → a 3-D line plot on `ax`."""
    if tree is None:
        tree = bm.canonical_skeleton()
    for p, c in _bones(tree):
        ax.plot([joint_pos[p, 0], joint_pos[c, 0]],
                [joint_pos[p, 1], joint_pos[c, 1]],
                [joint_pos[p, 2], joint_pos[c, 2]], color=color, linewidth=2)
    ax.scatter(joint_pos[:, 0], joint_pos[:, 1], joint_pos[:, 2], s=8,
               color=color)


def animate_rollout(body_pos_frames: np.ndarray, out_path: str = "rollout.gif",
                    tree=None, rewards: Optional[np.ndarray] = None,
                    traj: Optional[np.ndarray] = None, fps: int = 15,
                    elev: float = 20.0, azim: float = -60.0,
                    reward_labels: Optional[list] = None) -> str:
    """A rollout (T, J, 3) as a GIF, the target trajectory (V, 3) on the
    ground and each frame's reward (or reward_labels) in its title."""
    plt = _pyplot()
    from matplotlib import animation

    if tree is None:
        tree = bm.canonical_skeleton()
    frames = np.asarray(body_pos_frames)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")

    def draw(t):
        ax.cla()
        if traj is not None:
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2] * 0,
                    color="tab:red", linewidth=1, alpha=0.6)
        plot_skeleton_state(ax, frames[t], tree)
        c = frames[t, 0]
        ax.set_xlim(c[0] - 2, c[0] + 2)
        ax.set_ylim(c[1] - 2, c[1] + 2)
        ax.set_zlim(0, 2.2)
        ax.view_init(elev=elev, azim=azim)
        title = f"t={t}"
        if reward_labels is not None:
            title += "\n" + reward_labels[t]
        elif rewards is not None:
            title += f"  r={float(rewards[t]):+.3f}"
        ax.set_title(title, fontsize=9)

    anim = animation.FuncAnimation(fig, draw, frames=len(frames),
                                   interval=1000 / fps)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def plot_heightmap(heights: np.ndarray, out_path: Optional[str] = None):
    """A sensor or terrain height grid as an image (the reference's
    height_debug plotter); the path when `out_path` is given, else the
    figure."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(np.asarray(heights), cmap="terrain")
    fig.colorbar(im, ax=ax)
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
    return fig
