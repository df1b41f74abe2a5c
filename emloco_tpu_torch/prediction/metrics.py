"""Prediction losses and evaluation metrics on tensors (port of
emloco_tpu/prediction/metrics.py; reference
social-transmotion/utils/metrics.py).

  * mse_loss        — mean L2 over predicted frames ×100
  * mse_loss_multi  — winner-takes-all: the min over heads
  * ade_fde         — per mode, and their mean / min / worst over modes
  * des             — per-step displacement errors
  * initial_yaw_error
  * motion_primitives, and chi2_histogram_distance (numpy, on the host)
  * locoval_filter  — the LocoVal keep-mask with its argmax fallback
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _dist(a, b):
    return torch.linalg.vector_norm(a - b, dim=-1)


def mse_loss(pred, target):
    """pred (B,Fp,2), target (B,Fp,2) → scalar (mean L2 distance ×100)."""
    return _dist(pred, target).mean() * 100.0


def mse_loss_multi(pred_modes, target):
    """Winner-takes-all: pred_modes (B,Fp,M,2), target (B,Fp,2) → scalar.
    Min over modes of the per-sample mean L2, averaged over batch, ×100."""
    per_mode = _dist(pred_modes, target[:, :, None]).mean(1)    # (B,M)
    return per_mode.min(-1).values.mean() * 100.0


def ade_fde(pred_modes, target):
    """pred_modes (B,Fp,M,2), target (B,Fp,2) → dict(ade/fde each
    mean/min/worst over modes, and the per-sample (B,M) arrays)."""
    d = _dist(pred_modes, target[:, :, None])                   # (B,Fp,M)
    ade_m = d.mean(1)
    fde_m = d[:, -1]
    return {
        "ade_mean": ade_m.mean(),
        "ade_min": ade_m.min(-1).values.mean(),
        "ade_worst": ade_m.max(-1).values.mean(),
        "fde_mean": fde_m.mean(),
        "fde_min": fde_m.min(-1).values.mean(),
        "fde_worst": fde_m.max(-1).values.mean(),
        "ade_per_mode": ade_m,
        "fde_per_mode": fde_m,
    }


def des(pred, target):
    """Per-step displacement errors: (B,Fp,2)² → (Fp,)."""
    return _dist(pred, target).mean(0)


def initial_yaw_error(pred, target):
    """Angle in degrees between the first predicted displacement and the
    ground truth's, averaged (reference utils/metrics.py:48-65)."""
    dp, dt_ = pred[:, 0], target[:, 0]
    num = torch.sum(dp * dt_, -1)
    den = (torch.linalg.vector_norm(dp, dim=-1)
           * torch.linalg.vector_norm(dt_, dim=-1))
    cos = torch.clamp(num / torch.clamp(den, min=1e-8), -1.0, 1.0)
    return (torch.arccos(cos) * (180.0 / math.pi)).mean()


def motion_primitives(traj, dt: float = 0.4):
    """Speed, acceleration, angular velocity and angular acceleration at the
    prediction rate, traj (B,F,2). The reference's semantics
    (utils/metrics.py:67-105): acceleration |Δspeed|/dt; angular velocity
    |atan2(Δy, Δx)|/dt, the absolute displacement heading over dt."""
    v = torch.diff(traj, dim=1) / dt
    speed = torch.linalg.vector_norm(v, dim=-1)
    acc = torch.abs(torch.diff(speed, dim=1) / dt)
    ang_vel = torch.abs(torch.atan2(v[..., 1], v[..., 0]) / dt)
    ang_acc = torch.abs(torch.diff(ang_vel, dim=1) / dt)
    return dict(speed=speed, acc=acc, ang_vel=ang_vel, ang_acc=ang_acc)


def chi2_histogram_distance(a, b, bins=20, rng=None):
    """χ² distance between empirical histograms of two primitive samples
    (reference utils/metrics.py:107-137): 20 bins over the pooled range,
    per-bin probability mass, Σ (gᵢ−pᵢ)²/(gᵢ+pᵢ) where either is nonzero."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if hi <= lo:
        return 0.0
    edges = np.linspace(lo, hi, bins + 1)
    ha, _ = np.histogram(a, bins=edges, density=True)
    hb, _ = np.histogram(b, bins=edges, density=True)
    ha = ha * np.diff(edges)
    hb = hb * np.diff(edges)
    denom = ha + hb
    mask = denom > 0
    return float(np.sum((ha[mask] - hb[mask]) ** 2 / denom[mask]))


def locoval_filter(pred_modes, values, threshold: float = 0.7):
    """Keep the modes whose plausibility is at least `threshold`; where none
    passes, keep the argmax-value mode (reference evaluate_jta.py:320-357).
    pred_modes (B,Fp,M,2), values (B,M) → mask (B,M) bool."""
    keep = values >= threshold
    none = ~keep.any(-1, keepdim=True)
    best = torch.zeros_like(keep)
    best[torch.arange(values.shape[0], device=values.device),
         values.argmax(-1)] = True
    return torch.where(none, best, keep)
