"""Cross-stack export: prediction-side trajectories → sim-side banks (port
of emloco_tpu/prediction/export.py, numpy and scipy on the host).

The reference couples its two stacks through files on disk:
  * load_jta_traj.py:66-119 exports dataset trajectories as pkl — each
    13-waypoint (0.4 s) trajectory cubic-splined to 101 vertices at the sim's
    traj_phase — consumed by TrajGenerator (traj_generator.py:40-54) for
    "real-path" policy/LocoVal training;
  * load_jta_3dpose.py / load_jrdb_3dpose.py export matching initial poses.

Same capability here: spline scene trajectories to the (P, V, 2) bank layout
`envs.traj_gen.sample_traj(real_bank=…)` consumes, plus the initial pose/vel
side channel. No entry point loads such a bank into an env yet.
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np


# The reference's hand-typed knot table (load_jta_traj.py:72): 13 phases in
# [0, 0.8487]·100 at ~7.07 ( = 100/(10·√2) ) spacing with rounding drift
# (0.2122 and 0.5658 carry a +0.0001 correction). The spline is evaluated at
# 0..100, i.e. the last ~15 vertices EXTRAPOLATE the natural cubic past the
# final waypoint — the bank deliberately overshoots the 13-waypoint horizon
# so the sim episode (101-vertex track) outlives the predicted window.
REF_TRAJ_PHASE = np.array(
    [0.0000, 0.0707, 0.1414, 0.2122, 0.2829, 0.3536, 0.4243,
     0.4950, 0.5658, 0.6365, 0.7072, 0.7779, 0.8487]) * 100


def spline_to_vertices(waypoints: np.ndarray, num_verts: int = 101,
                       waypoint_dt: float = 0.4) -> np.ndarray:
    """(W, 2) waypoints → (num_verts, 2) natural cubic spline evaluated at
    integer phases 0..num_verts-1, reference-exact for W=13
    (load_jta_traj.py:72,92-95: CubicSpline(traj_phase, scene_data, axis=0,
    bc_type='natural') at np.arange(101), extrapolating past the last knot).
    waypoint_dt is accepted for call-site compatibility; the reference's
    phase table, not time, fixes the knot locations."""
    from scipy.interpolate import CubicSpline

    W = len(waypoints)
    if W == len(REF_TRAJ_PHASE):
        phase = REF_TRAJ_PHASE
    else:   # same ~100/(10√2) spacing for non-standard waypoint counts
        phase = np.arange(W) * (100.0 / (10.0 * np.sqrt(2.0)))
    cs = CubicSpline(phase, np.asarray(waypoints)[:, :2], axis=0,
                     bc_type="natural")
    return cs(np.arange(num_verts)).astype(np.float32)


def export_traj_bank(
    trajectories: Sequence[np.ndarray],   # list of (W, 2) waypoint tracks
    path: str,
    num_verts: int = 101,
    waypoint_dt: float = 0.4,
    init_poses: Optional[Sequence[np.ndarray]] = None,   # (24, 3) each
    init_vels: Optional[Sequence[np.ndarray]] = None,    # (2,) each
):
    """Write a sim-consumable bank pkl: dict with 'trajs' (P, V, 2) plus
    optional 'init_pose' (P, 24, 3) and 'init_vel' (P, 2).

    Pose frame convention: init poses are stored in the RAW dataset frame
    (same as the reference's exporters, load_jta_3dpose.py:44-51, which dump
    `person[0][:, 3:25]` unmodified) and stamped `pose_frame` so consumers
    can tell; anything feeding a ValuePoseNet must z-flip at consumption
    (×[1,1,−1], reference train_jta.py:264-266)."""
    bank = np.stack([spline_to_vertices(np.asarray(t), num_verts, waypoint_dt)
                     for t in trajectories])
    blob = {"trajs": bank, "pose_frame": "dataset_raw"}
    if init_poses is not None:
        blob["init_pose"] = np.stack([np.asarray(p) for p in init_poses])
    if init_vels is not None:
        blob["init_vel"] = np.stack([np.asarray(v) for v in init_vels])
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return bank


def load_traj_bank(path: str):
    """Load a bank pkl → (trajs (P,V,2) np, init_pose or None, init_vel or
    None). Also accepts the reference's format (dict of per-scene arrays or a
    raw array). Returned init poses are in the raw dataset frame (see
    export_traj_bank) — z-flip before feeding a ValuePoseNet."""
    from ..utils.checkpoint import load_data_pickle
    blob = load_data_pickle(path)
    if isinstance(blob, dict) and "trajs" in blob:
        return (blob["trajs"], blob.get("init_pose"), blob.get("init_vel"))
    if isinstance(blob, dict):
        arrs = [np.asarray(v)[..., :2] for v in blob.values()]
        return np.stack(arrs), None, None
    return np.asarray(blob)[..., :2], None, None


def export_scene_dataset(dataset, path: str, num_scenes: int = 256,
                         batch_size: int = 16):
    """Pull scenes from a prediction dataset (SyntheticScenes or
    NdjsonScenes) and export the primary agents' tracks as a sim bank."""
    from . import data as data_mod

    trajs, poses, vels = [], [], []
    for obs, mask, gt, init_pose, init_vel in dataset.batches(
            batch_size, max(1, num_scenes // batch_size)):
        obs = np.asarray(obs)
        gt = np.asarray(gt)
        full = np.concatenate([obs[:, :, 0, 0, :2],
                               gt], axis=1)               # (B, 21, 2)
        pose, vel = np.asarray(init_pose), np.asarray(init_vel)
        for b in range(full.shape[0]):
            # 13 waypoints: last obs + 12 predictions (reference exports the
            # 13-waypoint window fed to the valuenet)
            trajs.append(full[b, data_mod.OBS_FRAMES - 1:])
            poses.append(pose[b])
            vels.append(vel[b])
    return export_traj_bank(trajs, path, init_poses=poses, init_vels=vels)
