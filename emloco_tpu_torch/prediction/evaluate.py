"""Prediction evaluation: ADE/FDE and the LocoVal plausibility filter (port
of emloco_tpu/prediction/evaluate.py; reference evaluate_jta.py:140-507).

  * ADE/FDE mean/min/worst over heads, the final step's displacement error,
    the initial yaw error and χ² motion-primitive distances (:214-296,
    391-430)
  * the LocoVal filter: every head scored by the frozen ValuePoseNet, the
    heads with value ≥ 0.7 kept, else the argmax-value head; the filtered
    min, the value-picked and a random head's ADE (:320-357)
  * the ground truth's value (:298-318)
  * the filter-threshold sweep and the observation-length sweep (--all_frames,
    :617-621)

Each batch runs on the trainer's device and comes to the host once; the
per-batch rows are reduced on the host as the JAX package reduces them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..learning.networks import ValuePoseNet
from . import data as data_mod
from . import metrics as M

FILTER_THRESHOLD = 0.7  # evaluate_jta.py:526


def score_modes(vnet: ValuePoseNet, vnet_params, pred_modes, init_pose,
                init_vel):
    """Plausibility value per head: (B,Fp,M,2) → (B,M), every head through
    one LocoVal call."""
    B, Fp, Mm, _ = pred_modes.shape
    flat = pred_modes.movedim(2, 1).reshape(B * Mm, Fp, 2)
    traj = data_mod.prepend_origin(flat)
    pose = None if init_pose is None else init_pose.repeat_interleave(Mm, 0)
    vel = None if init_vel is None else init_vel.repeat_interleave(Mm, 0)
    return functional_call(vnet, vnet_params, (traj, pose, vel)).reshape(
        B, Mm)


def _flip(pose, pose_z_flip):
    return pose * torch.tensor([1.0, 1.0, -1.0 if pose_z_flip else 1.0],
                               device=pose.device)


@torch.no_grad()
def batch_eval(trainer, params, batch, vnet=None, vnet_params=None,
               threshold=FILTER_THRESHOLD, pose_z_flip=True) -> dict:
    """One batch's predictions scored on the device, as numpy: per-mode
    ADE and FDE, the first head's final-step error and yaw error, the
    motion primitives of its prediction and of the ground truth, and with
    a valuenet the values, the keep-mask and the ground truth's value."""
    obs, mask, gt, init_pose, init_vel = trainer.tensors(batch)
    pred = trainer.predict(params, obs, mask)                 # (B,Fp,M,2)
    af = M.ade_fde(pred, gt)
    res = dict(
        ade_m=af["ade_per_mode"], fde_m=af["fde_per_mode"],
        des_final=M.des(pred[:, :, 0], gt)[-1],
        iye=M.initial_yaw_error(pred[:, :, 0], gt),
        mp_pred=M.motion_primitives(data_mod.prepend_origin(pred[:, :, 0])),
        mp_gt=M.motion_primitives(data_mod.prepend_origin(gt)))
    if vnet is not None:
        pose = _flip(init_pose, pose_z_flip)
        values = score_modes(vnet, vnet_params, pred, pose, init_vel)
        res["values"] = values
        res["keep"] = M.locoval_filter(pred, values, threshold)
        res["gt_value_mean"] = functional_call(
            vnet, vnet_params,
            (data_mod.prepend_origin(gt), pose, init_vel)).mean()

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.cpu().numpy()

    return host(res)


def evaluate_with_filter(trainer, params, dataset, batch_size, num_batches,
                         vnet: Optional[ValuePoseNet] = None,
                         vnet_params=None, threshold=FILTER_THRESHOLD,
                         rng=None, pose_z_flip=True):
    """The full evaluation pass → the mean over batches of each metric."""
    rng = rng or np.random.RandomState(0)
    rows = []
    for batch in dataset.batches(batch_size, num_batches):
        o = batch_eval(trainer, params, batch, vnet, vnet_params, threshold,
                       pose_z_flip)
        ade_m, fde_m = o["ade_m"], o["fde_m"]
        row = {
            "ade_mean": float(ade_m.mean()),
            "ade_min": float(ade_m.min(-1).mean()),
            "ade_worst": float(ade_m.max(-1).mean()),
            "fde_mean": float(fde_m.mean()),
            "fde_min": float(fde_m.min(-1).mean()),
            "fde_worst": float(fde_m.max(-1).mean()),
            "des_final": float(o["des_final"]),
            "iye": float(o["iye"]),
        }
        for k in ("speed", "acc", "ang_vel", "ang_acc"):
            row[f"chi2_{k}"] = M.chi2_histogram_distance(
                o["mp_pred"][k], o["mp_gt"][k])
        if vnet is not None:
            values, keep = o["values"], o["keep"]
            # the kept fraction: a laxer filter lowers the kept-set min
            row["kept_frac"] = float(np.asarray(keep).mean())
            row["ade_filtered_min"] = float(
                np.where(keep, ade_m, np.inf).min(-1).mean())
            row["fde_filtered_min"] = float(
                np.where(keep, fde_m, np.inf).min(-1).mean())
            amax = values.argmax(-1)
            bidx = np.arange(len(amax))
            row["ade_value_pick"] = float(ade_m[bidx, amax].mean())
            rnd = rng.randint(0, ade_m.shape[1], len(amax))
            row["ade_random_pick"] = float(ade_m[bidx, rnd].mean())
            row["gt_value_mean"] = float(o["gt_value_mean"])
            row["pred_value_mean"] = float(values.mean())
        rows.append(row)
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


def filter_threshold_sweep(trainer, params, dataset, batch_size, num_batches,
                           vnet, vnet_params,
                           thresholds=(0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5,
                                       0.6, 0.7, 0.8, 0.9),
                           pose_z_flip=True):
    """Per-sample ADE, FDE and values from one pass, then the LocoVal
    keep-mask swept over `thresholds` on the host → {threshold:
    {"ade_filtered_min", "fde_filtered_min", "kept_frac"}}."""
    ades, fdes, values = [], [], []
    with torch.no_grad():
        for batch in dataset.batches(batch_size, num_batches):
            obs, mask, gt, init_pose, init_vel = trainer.tensors(batch)
            pred = trainer.predict(params, obs, mask)
            af = M.ade_fde(pred, gt)
            v = score_modes(vnet, vnet_params, pred,
                            _flip(init_pose, pose_z_flip), init_vel)
            ades.append(af["ade_per_mode"].cpu().numpy())
            fdes.append(af["fde_per_mode"].cpu().numpy())
            values.append(v.cpu().numpy())
    ade_m = np.concatenate(ades)                          # (S, M)
    fde_m = np.concatenate(fdes)
    vals = np.concatenate(values)
    amax = vals.argmax(-1)
    out = {}
    for t in thresholds:
        keep = vals >= t
        none = ~keep.any(-1)
        keep[none, amax[none]] = True                     # argmax fallback
        out[float(t)] = {
            "ade_filtered_min": float(np.where(keep, ade_m, np.inf)
                                      .min(-1).mean()),
            "fde_filtered_min": float(np.where(keep, fde_m, np.inf)
                                      .min(-1).mean()),
            "kept_frac": float(keep.mean()),
        }
    return out


def observation_length_sweep(trainer, params, dataset, batch_size,
                             num_batches, lengths=range(1, 10)):
    """min-ADE against the number of observed frames (reference
    --all_frames, evaluate_jta.py:617-621) → {length: ade_min}."""
    out = {}
    for L in lengths:
        rows = []
        for obs, mask, gt, *_ in dataset.batches(batch_size, num_batches):
            pred = trainer.predict(params, obs, mask, limit_obs=int(L))
            gt = torch.as_tensor(gt, device=pred.device)
            rows.append(M.ade_fde(pred, gt)["ade_min"].item())
        out[int(L)] = float(np.mean(rows))
    return out
