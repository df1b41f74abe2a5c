"""BVH mocap import → motion dicts (a numpy copy of
emloco_tpu/kinematics/bvh.py).

Counterpart of the reference's mocap ingestion (poselib's fbx importer,
skeleton3d.py:1195+, and uhc/khrylib's BVH reader, khrylib/mocap/). BVH is
plain text, read with no external SDK: HIERARCHY → the joint topology,
MOTION → per-frame local rotations, then joint-name conformance onto the
canonical 24-joint SMPL skeleton (curation.conform_joints) for motion_lib.

Angles follow the BVH spec: per-channel Euler rotations composed in file
order, intrinsic, degrees.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_ROT_CH = {"Xrotation": 0, "Yrotation": 1, "Zrotation": 2}
_POS_CH = {"Xposition": 0, "Yposition": 1, "Zposition": 2}


class BvhJoint:
    def __init__(self, name: str, parent: int):
        self.name = name
        self.parent = parent
        self.offset = np.zeros(3, np.float32)
        self.channels: List[str] = []


def parse_bvh(text: str) -> Tuple[List[BvhJoint], np.ndarray, float]:
    """→ (joints, frames (F, num_channels), frame_time)."""
    toks = text.replace("{", " { ").replace("}", " } ").split()
    i = 0
    joints: List[BvhJoint] = []
    stack: List[int] = []

    def expect(t):
        nonlocal i
        if toks[i] != t:
            raise ValueError(f"BVH parse: expected {t}, got {toks[i]}")
        i += 1

    expect("HIERARCHY")
    while toks[i] != "MOTION":
        t = toks[i]
        if t in ("ROOT", "JOINT"):
            name = toks[i + 1]
            joints.append(BvhJoint(name, stack[-1] if stack else -1))
            i += 2
            expect("{")
            stack.append(len(joints) - 1)
        elif t == "End":                  # End Site { OFFSET x y z }
            i += 2
            expect("{")
            while toks[i] != "}":
                i += 1
            i += 1
        elif t == "OFFSET":
            joints[stack[-1]].offset = np.array(
                [float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3])],
                np.float32)
            i += 4
        elif t == "CHANNELS":
            n = int(toks[i + 1])
            joints[stack[-1]].channels = toks[i + 2:i + 2 + n]
            i += 2 + n
        elif t == "}":
            stack.pop()
            i += 1
        else:
            raise ValueError(f"BVH parse: unexpected token {t}")
    expect("MOTION")
    expect("Frames:")
    num_frames = int(toks[i]); i += 1
    expect("Frame")
    expect("Time:")
    frame_time = float(toks[i]); i += 1
    vals = np.array([float(x) for x in toks[i:]], np.float32)
    n_ch = sum(len(j.channels) for j in joints)
    frames = vals[:num_frames * n_ch].reshape(num_frames, n_ch)
    return joints, frames, frame_time


def _euler_to_aa(order: Sequence[str], degs: np.ndarray) -> np.ndarray:
    """Compose per-channel rotations in file order (intrinsic) → axis-angle.
    degs (F, k) for k rotation channels."""
    F = len(degs)
    R = np.tile(np.eye(3, dtype=np.float64), (F, 1, 1))
    for c, ang in zip(order, degs.T):
        a = np.deg2rad(ang.astype(np.float64))
        ca, sa = np.cos(a), np.sin(a)
        Rc = np.zeros((F, 3, 3))
        ax = _ROT_CH[c]
        if ax == 0:
            Rc[:, 0, 0] = 1
            Rc[:, 1, 1] = ca; Rc[:, 1, 2] = -sa
            Rc[:, 2, 1] = sa; Rc[:, 2, 2] = ca
        elif ax == 1:
            Rc[:, 1, 1] = 1
            Rc[:, 0, 0] = ca; Rc[:, 0, 2] = sa
            Rc[:, 2, 0] = -sa; Rc[:, 2, 2] = ca
        else:
            Rc[:, 2, 2] = 1
            Rc[:, 0, 0] = ca; Rc[:, 0, 1] = -sa
            Rc[:, 1, 0] = sa; Rc[:, 1, 1] = ca
        R = R @ Rc                       # intrinsic: post-multiply
    # rotation matrix → axis-angle
    tr = np.clip((R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1) / 2, -1, 1)
    theta = np.arccos(tr)
    axis = np.stack([R[:, 2, 1] - R[:, 1, 2],
                     R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], -1)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.where(norm > 1e-8, axis / np.maximum(norm, 1e-12),
                    np.array([1.0, 0.0, 0.0]))
    return (axis * theta[:, None]).astype(np.float32)


# Common BVH joint-name vocabularies → canonical SMPL names
_NAME_MAP = {
    "hips": "Pelvis", "hip": "Pelvis", "pelvis": "Pelvis",
    "leftupleg": "L_Hip", "lefthip": "L_Hip", "lthigh": "L_Hip",
    "leftleg": "L_Knee", "leftknee": "L_Knee", "ltibia": "L_Knee",
    "leftfoot": "L_Ankle", "leftankle": "L_Ankle", "lfoot": "L_Ankle",
    "lefttoebase": "L_Toe", "lefttoe": "L_Toe",
    "rightupleg": "R_Hip", "righthip": "R_Hip", "rthigh": "R_Hip",
    "rightleg": "R_Knee", "rightknee": "R_Knee", "rtibia": "R_Knee",
    "rightfoot": "R_Ankle", "rightankle": "R_Ankle", "rfoot": "R_Ankle",
    "righttoebase": "R_Toe", "righttoe": "R_Toe",
    "spine": "Torso", "spine1": "Spine", "spine2": "Chest", "chest": "Chest",
    "neck": "Neck", "head": "Head",
    "leftshoulder": "L_Thorax", "leftcollar": "L_Thorax",
    "leftarm": "L_Shoulder", "leftuparm": "L_Shoulder",
    "leftforearm": "L_Elbow", "leftelbow": "L_Elbow",
    "lefthand": "L_Wrist", "leftwrist": "L_Wrist",
    "rightshoulder": "R_Thorax", "rightcollar": "R_Thorax",
    "rightarm": "R_Shoulder", "rightuparm": "R_Shoulder",
    "rightforearm": "R_Elbow", "rightelbow": "R_Elbow",
    "righthand": "R_Wrist", "rightwrist": "R_Wrist",
}


def canonical_name(bvh_name: str) -> Optional[str]:
    key = bvh_name.lower().replace("_", "").replace(":", "")
    if key in _NAME_MAP:
        return _NAME_MAP[key]
    from .body_model import BODY_NAMES
    return bvh_name if bvh_name in BODY_NAMES else None


def load_bvh(path_or_text: str, scale: float = 0.01,
             y_up: bool = True) -> Dict:
    """BVH file → motion dict {pose_aa (F,72), root_trans_offset (F,3), beta,
    fps}. `scale` converts BVH units (commonly cm) to meters; y_up applies
    the same basis change as the AMASS ingest."""
    from .curation import _UPRIGHT_R, conform_joints

    text = path_or_text
    if "\n" not in path_or_text and not path_or_text.lstrip().startswith(
            "HIERARCHY"):
        with open(path_or_text) as f:
            text = f.read()
    joints, frames, frame_time = parse_bvh(text)

    # per-joint local axis-angle + root translation
    F = len(frames)
    aa = np.zeros((F, len(joints), 3), np.float32)
    trans = np.zeros((F, 3), np.float32)
    c0 = 0
    for j, jt in enumerate(joints):
        rot_order = [c for c in jt.channels if c in _ROT_CH]
        for k, c in enumerate(jt.channels):
            if c in _POS_CH and jt.parent == -1:
                trans[:, _POS_CH[c]] = frames[:, c0 + k]
            k_rot = [k for k, c in enumerate(jt.channels) if c in _ROT_CH]
        if rot_order:
            aa[:, j] = _euler_to_aa(rot_order, frames[:, c0 + np.array(k_rot)])
        c0 += len(jt.channels)
    trans *= scale

    names = [canonical_name(j.name) or f"__{j.name}" for j in joints]
    pose_aa = conform_joints(aa.reshape(F, -1), names).reshape(F, 24, 3)
    if y_up:
        pose_aa = pose_aa @ _UPRIGHT_R.T
        trans = trans @ _UPRIGHT_R.T
    return {"pose_aa": pose_aa.reshape(F, 72),
            "root_trans_offset": trans.astype(np.float32),
            "beta": np.zeros(16, np.float32),
            "fps": 1.0 / frame_time}
