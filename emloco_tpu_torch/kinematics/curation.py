"""Motion dataset curation — filter/merge/split/augment motion dicts (port
of emloco_tpu/kinematics/curation.py: numpy, with the AMASS ground fix
through the port's forward kinematics on torch).

Counterpart of the reference's offline data tooling:
  * data_tree.py (motion dataset curation, pacer/pacer/utils/data_tree.py)
  * convert_amass_isaac.py (upright correction + left-right flip
    augmentation, uhc/data_process/convert_amass_isaac.py:292-321)

Operates on the reference pkl schema ({name: {pose_aa, root_trans_offset,
beta, fps}}) so curated sets flow straight into motion_lib.load_reference_pkl.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional, Sequence

import numpy as np

# SMPL left/right joint swap (pose_aa layout)
from .body_model import BODY_NAMES


def load_motion_dict(path: str) -> Dict:
    """A motion pickle, read with the checkpoint unpickler (a joblib file
    raises ValueError)."""
    from ..utils.checkpoint import load_data_pickle
    return load_data_pickle(path)


def save_motion_dict(d: Dict, path: str):
    with open(path, "wb") as f:
        pickle.dump(d, f)


def filter_motions(d: Dict, min_seconds: float = 1.0,
                   max_seconds: Optional[float] = None,
                   name_allowlist: Optional[Sequence[str]] = None,
                   predicate: Optional[Callable] = None) -> Dict:
    """Duration/name/predicate filtering (curated-list semantics of
    convert_amass_isaac.py:27-200)."""
    out = {}
    for name, m in d.items():
        fps = float(m.get("fps", 30.0))
        dur = len(np.asarray(m["pose_aa"])) / fps
        if dur < min_seconds:
            continue
        if max_seconds is not None and dur > max_seconds:
            continue
        if name_allowlist is not None and not any(
                a in name for a in name_allowlist):
            continue
        if predicate is not None and not predicate(name, m):
            continue
        out[name] = m
    return out


def merge_motion_dicts(*dicts: Dict) -> Dict:
    out = {}
    for i, d in enumerate(dicts):
        for k, v in d.items():
            out[f"{k}" if k not in out else f"{k}__{i}"] = v
    return out


def train_test_split(d: Dict, test_frac: float = 0.1, seed: int = 0):
    rng = np.random.RandomState(seed)
    names = sorted(d)
    rng.shuffle(names)
    n_test = max(1, int(len(names) * test_frac))
    test = {n: d[n] for n in names[:n_test]}
    train = {n: d[n] for n in names[n_test:]}
    return train, test


def _mirror_joint_index():
    """Each SMPL joint's left/right counterpart (itself on the midline)."""
    def twin(n):
        if n[:2] in ("L_", "R_"):
            return ("R_" if n[0] == "L" else "L_") + n[2:]
        return n
    return np.array([BODY_NAMES.index(twin(n)) for n in BODY_NAMES])


def flip_motion_lr(m: Dict) -> Dict:
    """Left-right mirror a motion (the reference's flip augmentation,
    convert_amass_isaac.py:302-304, re-derived for our z-up frame): swap L/R
    joints and mirror every rotation across the y=0 (xz) plane. For a
    reflection M=diag(1,-1,1), M·R(a,θ)·M = R(Ma,−θ), so the axis-angle
    vector transforms (x,y,z) → (−x, y, −z); root translation flips y."""
    pose = np.asarray(m["pose_aa"], np.float32).reshape(-1, 24, 3).copy()
    pose = pose[:, _mirror_joint_index()]
    pose[..., 0] *= -1.0
    pose[..., 2] *= -1.0
    trans = np.asarray(m["root_trans_offset"], np.float32).copy()
    trans[:, 1] *= -1.0
    out = dict(m)
    out["pose_aa"] = pose.reshape(-1, 72)
    out["root_trans_offset"] = trans
    return out


def augment_with_flips(d: Dict) -> Dict:
    out = dict(d)
    for name, m in d.items():
        out[name + "_flip"] = flip_motion_lr(m)
    return out


# ---------------------------------------------------------------------------
# Raw AMASS ingest (counterpart of the reference's offline pipeline
# process_amass_raw.py → process_amass_db.py → convert_amass_isaac.py —
# re-derived: downsample, body-joint slice, y-up → z-up upright correction,
# FK-based ground height fix; no torch/smplx dependency)
# ---------------------------------------------------------------------------

# Basis change W from SMPL's y-up frame to our z-up/x-forward frame (the
# cyclic axis permutation the reference bakes in as quat [0.5,0.5,0.5,0.5],
# convert_amass_isaac.py:292). Re-expressing every local rotation in the new
# basis is conjugation g → W g W⁻¹, which for axis-angle vectors is simply
# aa → W·aa; translations map as t → W·t.
_UPRIGHT_R = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)


def conform_joints(pose_aa_src: np.ndarray, source_names: Sequence[str],
                   target_names: Sequence[str] = None) -> np.ndarray:
    """Remap per-joint axis-angle data between skeleton layouts by joint
    name; missing target joints get zeros. Covers the reference's masterfoot
    remap (motion_lib_smpl.py:101-119 — subdivided-foot skeletons → standard)
    and SMPL-H/X 52/55-joint AMASS data → 24-joint SMPL."""
    target_names = tuple(target_names or BODY_NAMES)
    src = np.asarray(pose_aa_src, np.float32).reshape(
        len(pose_aa_src), len(source_names), 3)
    out = np.zeros((len(src), len(target_names), 3), np.float32)
    lookup = {n: i for i, n in enumerate(source_names)}
    for t, name in enumerate(target_names):
        if name in lookup:
            out[:, t] = src[:, lookup[name]]
    return out.reshape(len(src), -1)


def amass_to_motion(npz_path_or_dict, target_fps: float = 30.0,
                    ground_fix: bool = True) -> Dict:
    """One raw AMASS sequence (npz with poses/trans/betas/mocap_framerate)
    → our motion-dict schema {pose_aa (F,72), root_trans_offset (F,3),
    beta (16,), fps}."""
    import torch

    from . import body_model as bm
    from .skeleton import forward_kinematics
    from ..ops import quat

    d = npz_path_or_dict
    if isinstance(d, str):
        d = dict(np.load(d, allow_pickle=True))
    poses = np.asarray(d["poses"], np.float32)
    trans = np.asarray(d["trans"], np.float32)
    fps_in = float(np.asarray(d.get("mocap_framerate",
                                    d.get("mocap_frame_rate", 60.0))))
    betas = np.asarray(d.get("betas", np.zeros(16)), np.float32)[:16]
    betas = np.pad(betas, (0, 16 - len(betas)))

    # temporal downsample to target_fps
    step = max(1, int(round(fps_in / target_fps)))
    poses, trans = poses[::step], trans[::step]
    fps = fps_in / step

    # body-joint slice: first 22 SMPL joints; hands (22, 23) zeroed
    pose_aa = np.zeros((len(poses), 24, 3), np.float32)
    pose_aa[:, :22] = poses[:, :66].reshape(-1, 22, 3)

    # upright correction: conjugate every local rotation into the z-up basis
    # (axis-angle vectors rotate by W) and rotate the root translation
    pose_aa = pose_aa @ _UPRIGHT_R.T
    trans = trans @ _UPRIGHT_R.T

    if ground_fix:
        # FK the lowest joint over all frames onto the ground (the reference
        # uses the SMPL mesh; joint minimum + toe radius is our analogue)
        tree = bm.canonical_skeleton()
        local = quat.exp_map_to_quat(torch.from_numpy(pose_aa))
        _, gpos = forward_kinematics(tree, local, torch.from_numpy(trans))
        trans[:, 2] -= float(gpos[..., 2].min()) - 0.02

    return {"pose_aa": pose_aa.reshape(-1, 72).astype(np.float32),
            "root_trans_offset": trans.astype(np.float32),
            "beta": betas, "fps": fps}


def amass_directory_to_dict(paths: Sequence[str], target_fps: float = 30.0,
                            max_motions: Optional[int] = None) -> Dict:
    """Batch-convert raw AMASS npz files (skips non-motion npz like
    shape.npz), keyed by filename stem."""
    import os

    out = {}
    for p in paths:
        if max_motions is not None and len(out) >= max_motions:
            break
        try:
            d = dict(np.load(p, allow_pickle=True))
        except (OSError, ValueError):
            continue
        if "poses" not in d or "trans" not in d:
            continue
        name = os.path.splitext(os.path.basename(p))[0]
        out[name] = amass_to_motion(d, target_fps=target_fps)
    return out
