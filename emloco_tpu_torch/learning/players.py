"""Policy and value evaluation artifacts (port of
emloco_tpu/learning/players.py; reference amp_value_players.py:129-275,
the value-against-return scatter and histograms, and base_task.py:799-844,
rollout videos with per-step reward overlays).

`rollout_with_rewards` runs on the agent's device: an eager loop of control
steps (observe → `agent._policy` → `env.step`), so on the card each step
launches the block-arrow factor once and the resolve once per substep.
The plots are matplotlib on the host, imported inside each function; a
call without matplotlib raises ImportError.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..physics import body_frame_state


@torch.no_grad()
def rollout_with_rewards(agent, ts, steps: int, env_index: int = 0,
                         deterministic: bool = True, seed: int = 0):
    """Roll the frozen policy from ts.env_state and record one env's body
    positions and reward terms. The action noise is drawn on a generator
    seeded with `seed` (taken with deterministic=False; mu otherwise).

    Returns (frames (T, 24, 3), {"total", "loc"[, "power"]} of (T,) arrays,
    that env's trajectory vertices (V, 3)), as numpy."""
    env = agent.env
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = ts.env_state
    frames, rew, raw = [], [], []
    for _ in range(steps):
        obs = env.observe(state)
        a, mu, *_ = agent._policy(ts.params, ts.obs_norm, obs, gen)
        state, out = env.step(state, mu if deterministic else a)
        pos = body_frame_state(env.model, state.physics)[0]
        frames.append(pos[env_index])
        rew.append(out.reward[env_index])
        raw.append(out.reward_raw[env_index])
    frames = torch.stack(frames).cpu().numpy()                # (T, 24, 3)
    rew = torch.stack(rew).cpu().numpy()
    raw = torch.stack(raw).cpu().numpy()                      # (T, 2+)
    rewards = {"total": rew, "loc": raw[:, 0]}
    if raw.shape[1] > 1:
        rewards["power"] = raw[:, 1]
    return frames, rewards, state.traj_verts[env_index].cpu().numpy()


def save_rollout_gif(agent, ts, out_path: str, steps: int = 90,
                     env_index: int = 0) -> str:
    """One rollout GIF with each step's reward terms in its title."""
    from ..kinematics.visualization import animate_rollout

    frames, rewards, traj = rollout_with_rewards(agent, ts, steps, env_index)
    labels = ["  ".join(f"{k}={rewards[k][t]:+.3f}" for k in rewards)
              for t in range(len(frames))]
    return animate_rollout(frames, out_path, rewards=rewards["total"],
                           traj=traj, reward_labels=labels)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_value_scatter(preds: np.ndarray, targets: np.ndarray,
                       out_path: str, mse: Optional[float] = None,
                       corr: Optional[float] = None) -> str:
    """Value prediction against realized return, with the y = x diagonal
    (reference amp_value_players.py:198-247)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(targets, preds, s=12, alpha=0.6, edgecolors="none")
    lo = float(min(targets.min(), preds.min(), 0.0))
    hi = float(max(targets.max(), preds.max(), 1.0))
    ax.plot([lo, hi], [lo, hi], color="gray", linestyle="--", linewidth=1)
    ax.set_xlabel("realized normalized return")
    ax.set_ylabel("valuenet prediction")
    title = f"LocoVal prediction ({len(preds)} episodes)"
    if mse is not None:
        title += f"  mse={mse:.4f}"
    if corr is not None:
        title += f"  corr={corr:.3f}"
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_value_histograms(preds: np.ndarray, targets: np.ndarray,
                          out_path: str) -> str:
    """The predictions' and the realized returns' distributions side by
    side (reference amp_value_players.py:248-275)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    bins = np.linspace(0.0, 1.0, 31)
    ax.hist(targets, bins=bins, alpha=0.55, label="realized return")
    ax.hist(preds, bins=bins, alpha=0.55, label="valuenet prediction")
    ax.set_xlabel("normalized return")
    ax.set_ylabel("episodes")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def save_eval_artifacts(trainer, vts, out_dir: str, name: str = "default",
                        num_epochs: int = 4, gif_steps: int = 90,
                        preds: Optional[np.ndarray] = None,
                        targets: Optional[np.ndarray] = None):
    """The scatter, the histograms and one rollout GIF. (preds, targets)
    from trainer.collect_predictions reuse its rollouts; without them
    num_epochs fresh evaluation epochs are collected. Returns (vts, paths
    and metrics)."""
    os.makedirs(out_dir, exist_ok=True)
    if preds is None or targets is None:
        vts, preds, targets = trainer.collect_predictions(vts, num_epochs)
    out = {}
    if len(preds):
        mse, corr = trainer.prediction_stats(preds, targets)
        out["mse"], out["corr"] = mse, corr
        out["scatter"] = plot_value_scatter(
            preds, targets, os.path.join(out_dir, f"value_scatter_{name}.png"),
            mse=mse, corr=corr)
        out["hist"] = plot_value_histograms(
            preds, targets, os.path.join(out_dir, f"value_hist_{name}.png"))
    out["gif"] = save_rollout_gif(
        trainer.agent, vts.policy,
        os.path.join(out_dir, f"rollout_{name}.gif"), steps=gif_steps)
    return vts, out
