"""Prediction visualization: multi-model comparison plots, value/ADE bars,
histograms and per-sample 3-D plots (port of emloco_tpu/prediction/
visualize.py).

Counterpart of the reference's analysis plots:
  * visualize_pred.py:17-148 — multi-model BEV comparison from saved vis_dict
    pkls (observed track, GT future, per-model multi-head predictions).
  * draw_histogram.py — value histograms across prediction sets.
  * evaluate_jta.py:432-493 — value-binned ADE bars, value histograms.

`collect_vis_data` runs the predictor and the LocoVal scoring on the
trainer's device and copies each batch to the host once. The plots are
numpy and matplotlib on the host; matplotlib is imported inside each plot
function, so the module imports without it, and a plot call without it
raises ImportError.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .evaluate import _flip, score_modes


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_vis_dict(path: str, vis: Dict):
    """Persist an evaluation's visualization payload (the reference stores
    `vis_dict` pkls from evaluate_jta and replots them in visualize_pred)."""
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(v) if not isinstance(v, dict) else v
                     for k, v in vis.items()}, f)


def load_vis_dict(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Same-dtype tensors on one device → numpy, in one copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()]).cpu().numpy()
    out, i = {}, 0
    for k, t in tensors.items():
        out[k] = flat[i:i + t.numel()].reshape(t.shape)
        i += t.numel()
    return out


@torch.no_grad()
def collect_vis_data(trainer, params, dataset, batch_size=32, num_batches=1,
                     vnet=None, vnet_params=None, pose_z_flip=True) -> Dict:
    """Inference over `num_batches` batches, collecting what the comparison
    plots need: the primary agent's observed track (S, Fo, 2), the ground
    truth (S, Fp, 2), the heads' predictions (S, Fp, M, 2), the initial pose
    in the z-up frame the valuenet consumes (S, 24, 3) and, with a
    valuenet, each head's value (S, M)."""
    rows = []
    for batch in dataset.batches(batch_size, num_batches):
        obs, mask, gt, init_pose, init_vel = trainer.tensors(batch)
        pred = trainer.predict(params, obs, mask)            # (B,Fp,M,2)
        pose = _flip(init_pose, pose_z_flip)
        row = {"obs": obs[:, :, 0, 0, :2], "gt": gt, "pred": pred,
               "init_pose": pose}
        if vnet is not None:
            row["values"] = score_modes(vnet, vnet_params, pred, pose,
                                        init_vel)
        rows.append(_to_host(row))
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def plot_prediction_comparison(vis_by_model: Dict[str, Dict],
                               scene_indices: Sequence[int],
                               out_path: str,
                               value_threshold: Optional[float] = None):
    """BEV multi-model, multi-scene comparison grid (visualize_pred.py
    semantics): black observed track, green GT future, one color per model,
    one faint line per prediction head (dashed when its LocoVal value falls
    below the threshold)."""
    plt = _pyplot()
    n_models = len(vis_by_model)
    n_scenes = len(scene_indices)
    fig, axes = plt.subplots(n_scenes, n_models,
                             figsize=(3.2 * n_models, 3.2 * n_scenes),
                             squeeze=False)
    colors = plt.cm.tab10.colors
    for col, (name, vis) in enumerate(vis_by_model.items()):
        for row, s in enumerate(scene_indices):
            ax = axes[row][col]
            obs, gt, pred = vis["obs"][s], vis["gt"][s], vis["pred"][s]
            ax.plot(obs[:, 0], obs[:, 1], "k.-", lw=1.5, label="obs")
            gseg = np.concatenate([obs[-1:], gt], 0)
            ax.plot(gseg[:, 0], gseg[:, 1], "-", c="tab:green", lw=2,
                    label="GT")
            vals = vis.get("values")
            for m in range(pred.shape[1]):
                pseg = np.concatenate([obs[-1:, :2], pred[:, m]], 0)
                style = "-"
                if (value_threshold is not None and vals is not None
                        and vals[s, m] < value_threshold):
                    style = ":"
                ax.plot(pseg[:, 0], pseg[:, 1], style,
                        c=colors[col % 10], alpha=0.45, lw=1)
            if row == 0:
                ax.set_title(name)
            ax.set_aspect("equal")
            if row == 0 and col == 0:
                ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def per_sample_min_metrics(vis: Dict):
    """Per-sample min-over-heads ADE/FDE from a vis_dict (the quantities
    draw_histogram.py reads back out of the reference's saved eval tuples,
    indices 6/9)."""
    gt = vis["gt"][:, :, None, :]                        # (S, Fp, 1, 2)
    d = np.linalg.norm(vis["pred"] - gt, axis=-1)        # (S, Fp, M)
    return d.mean(1).min(-1), d[:, -1].min(-1)


def plot_metric_diff_histograms(vis_by_model: Dict[str, Dict], ours: str,
                                out_path: str, bins: int = 10):
    """Per-sample ADE/FDE improvement histograms of `ours` against every
    other model in `vis_by_model` (reference draw_histogram.py: histograms
    of metric_baseline − metric_ours, one figure per metric × baseline,
    10 bins). Positive mass = samples where ours is better; each panel is
    annotated with that improved fraction."""
    plt = _pyplot()
    baselines = [k for k in vis_by_model if k != ours]
    if not baselines:
        raise ValueError("need at least one baseline vis_dict besides "
                         f"'{ours}'")
    # vis dicts may carry different sample counts (different eval batch
    # budgets); per-sample differences are only meaningful on the common
    # prefix, so truncate all metric arrays to min n (mirrors the
    # comparison plot's handling in cmd_visualize_pred)
    n = min(v["pred"].shape[0] for v in vis_by_model.values())
    ade_o, fde_o = per_sample_min_metrics(vis_by_model[ours])
    ade_o, fde_o = ade_o[:n], fde_o[:n]
    fig, axes = plt.subplots(len(baselines), 2,
                             figsize=(8.0, 3.0 * len(baselines)),
                             squeeze=False)
    for r, name in enumerate(baselines):
        ade_b, fde_b = per_sample_min_metrics(vis_by_model[name])
        ade_b, fde_b = ade_b[:n], fde_b[:n]
        for c, (lbl, diffs) in enumerate([("ADE", ade_b - ade_o),
                                          ("FDE", fde_b - fde_o)]):
            ax = axes[r][c]
            ax.hist(diffs, bins=bins, alpha=0.8, edgecolor="black")
            ax.axvline(0.0, color="k", lw=1)
            frac = float((diffs > 0).mean())
            ax.set_title(f"{lbl} {name} − {ours}  "
                         f"(improved {frac:.0%})", fontsize=9)
            ax.set_xlabel(f"Δ{lbl} [m]", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_value_ade_bars(values: np.ndarray, ades: np.ndarray, out_path: str,
                        num_bins: int = 10):
    """Mean ADE per LocoVal-value bin (evaluate_jta.py:432-493): shows whether
    low-value (implausible) heads really are worse predictions."""
    plt = _pyplot()
    values = np.asarray(values).reshape(-1)
    ades = np.asarray(ades).reshape(-1)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    means, counts = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (values >= lo) & (values < hi)
        means.append(float(ades[m].mean()) if m.any() else 0.0)
        counts.append(int(m.sum()))
    fig, ax1 = plt.subplots(figsize=(6, 4))
    ax1.bar(centers, means, width=0.8 / num_bins, color="tab:blue",
            label="mean ADE")
    ax1.set_xlabel("LocoVal value")
    ax1.set_ylabel("mean ADE [m]")
    ax2 = ax1.twinx()
    ax2.plot(centers, counts, "o-", c="tab:orange", label="count")
    ax2.set_ylabel("samples")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return {"bin_centers": centers, "mean_ade": np.array(means),
            "counts": np.array(counts)}


def plot_value_histogram(values_by_group: Dict[str, np.ndarray],
                         out_path: str, bins: int = 30):
    """Overlaid value histograms across groups (draw_histogram.py), e.g.
    {"pred": ..., "GT": ..., "random": ...}."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, v in values_by_group.items():
        ax.hist(np.asarray(v).reshape(-1), bins=bins, range=(0, 1),
                alpha=0.5, label=name, density=True)
    ax.set_xlabel("LocoVal value")
    ax.set_ylabel("density")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_des_per_step(des_by_model: Dict[str, np.ndarray], out_path: str,
                      dt: float = 0.4):
    """Displacement error vs. prediction horizon (evaluate_jta DES curves)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, des in des_by_model.items():
        des = np.asarray(des)
        t = (np.arange(len(des)) + 1) * dt
        ax.plot(t, des, "o-", label=name)
    ax.set_xlabel("horizon [s]")
    ax.set_ylabel("DES [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


# SMPL joint-pair edges drawn by the reference's 3-D visualizer
# (evaluate_jta.py:44 / value_pose_net.py:20): limbs + root fan, skipping the
# toe/spine joints the LocoVal net also hides.
SMPL_SKELETON_EDGES = (
    (0, 1), (1, 2), (2, 3), (0, 5), (5, 6), (6, 7), (0, 12), (12, 13),
    (0, 14), (14, 15), (15, 16), (16, 17), (17, 18), (0, 19), (19, 20),
    (20, 21), (21, 22), (22, 23),
)


def plot_3d_sample(vis: Dict, sample: int, out_path: str,
                   model_name: str = "Pred", past_len: int = 9,
                   pose_scale: float = 2.0, ground_z: float = -1.5):
    """Per-sample 3-D plot — the reference's Visualizer_3D.plot_3d
    (evaluate_jta.py:39-138): past/GT/multi-head predicted trajectories on
    the ground plane plus the initial SMPL skeleton (scaled for legibility),
    prediction heads colored by their LocoVal value (viridis) when values
    are present.

    vis: a vis_dict from collect_vis_data (needs "init_pose" for the
    skeleton; silently skips it when absent, e.g. old pkls)."""
    obs = vis["obs"][sample]
    gt = vis["gt"][sample]
    pred = vis["pred"][sample]                           # (Fp, M, 2)
    values = vis.get("values")

    plt = _pyplot()
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=40, azim=-50)
    last = obs[-1]
    ax.set_xlim(last[0] - 3, last[0] + 6)
    ax.set_ylim(last[1] - 3, last[1] + 1)
    ax.set_zlim(ground_z - 0.5, 1.5)
    ax.set_box_aspect([9, 4, 3.5 + 0.5 - ground_z - 1.5])
    for axis in (ax.xaxis, ax.yaxis, ax.zaxis):
        axis.set_ticks([])

    # past trajectory on the ground plane
    p = obs[-past_len:]
    ax.plot(p[:, 0], p[:, 1], np.full(len(p), ground_z), c="k",
            label=f"Past ({len(p)} frames)", lw=1.5, marker="o", ms=3)

    # initial SMPL skeleton above the last observed point
    pose = vis.get("init_pose")
    if pose is not None:
        pts = pose[sample] * pose_scale
        pts = pts + np.array([last[0], last[1], 0.0])
        for a, b in SMPL_SKELETON_EDGES:
            ax.plot(pts[[a, b], 0], pts[[a, b], 1], pts[[a, b], 2],
                    c="magenta", lw=1.5, marker="o", ms=2)

    # ground-truth future
    g = np.concatenate([obs[-1:], gt], 0)
    ax.plot(g[:, 0], g[:, 1], np.full(len(g), ground_z), c="r",
            label="Ground Truth", lw=2, marker="o", ms=3)

    # prediction heads, value-colored when LocoVal values exist
    for m in range(pred.shape[1]):
        seg = np.concatenate([obs[-1:], pred[:, m]], 0)
        if values is not None:
            color = plt.cm.viridis(float(np.clip(values[sample, m], 0, 1)))
        else:
            color = "darkorange"
        ax.plot(seg[:, 0], seg[:, 1], np.full(len(seg), ground_z), c=color,
                ls="--", lw=1.5,
                label=model_name if m == 0 else None)
    ax.legend(fontsize=8, ncol=2)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_3d_plots(vis: Dict, out_dir: str, num_samples: int = 4,
                  model_name: str = "Pred") -> list:
    """Emit per-sample 3-D plots named by sample id and min-ADE (the
    reference saves batch{b}_person{k}_ade{a}.png, evaluate_jta.py:133-138)."""
    os.makedirs(out_dir, exist_ok=True)
    ade, _ = per_sample_min_metrics(vis)
    paths = []
    for s in range(min(num_samples, vis["pred"].shape[0])):
        out = os.path.join(out_dir, f"sample{s}_ade{float(ade[s]):.2f}.png")
        paths.append(plot_3d_sample(vis, s, out, model_name=model_name))
    return paths
