"""Motion retargeting between skeletons through T-pose calibration.

Port of emloco_tpu/kinematics/retarget.py (poselib's
SkeletonState.retarget_to / retarget_to_by_tpose, skeleton3d.py:813-1025):

  1. align the source with the target frame (`rotation_to_target`, t_R_s:
     it pre-multiplies every global rotation and rotates the root paths);
  2. root translation = target T-pose root + (source root − source T-pose
     root, in the target frame) × `scale` (skeleton3d.py:936-941, 973-975);
  3. each mapped joint's global delta from the source T-pose is moved onto
     the target T-pose orientation (delta = g_src · g_src_tposeᵀ;
     g_tgt = delta · g_tgt_tpose, skeleton3d.py:944-960);
  4. an unmapped target joint takes its nearest mapped ancestor's global
     rotation (the reference's parent walk, skeleton3d.py:962-975);
  5. back to local rotations on the target tree.

Batched over frames, on the device of the inputs.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import quat
from .skeleton import SkeletonTree, forward_kinematics, local_from_global


def _auto_leg_scale(source_tree: SkeletonTree,
                    target_tree: SkeletonTree) -> float:
    """The ratio of the two legs' lengths (the ankle's vertical drop to the
    root at T-pose): the scale for callers without a calibrated unit
    factor."""
    def leg(tree):
        lt = tree.local_translation
        j = next((tree.index(c) for c in ("L_Ankle", "l_ankle", "LeftFoot")
                  if c in tree.names), None)
        if j is None:
            return 1.0
        drop = 0.0
        while tree.parents[j] >= 0:
            drop += abs(float(lt[j][2]))
            j = int(tree.parents[j])
        return max(drop, 1e-3)

    return leg(target_tree) / leg(source_tree)


def retarget_motion(
    source_tree: SkeletonTree,
    target_tree: SkeletonTree,
    joint_map: Dict[str, str],          # target joint name → source joint name
    source_local_rot: torch.Tensor,     # (F, Js, 4)
    source_root_pos: torch.Tensor,      # (F, 3)
    source_tpose_rot: torch.Tensor = None,   # (Js, 4) source T-pose local rots
    target_tpose_rot: torch.Tensor = None,   # (Jt, 4)
    source_tpose_root: torch.Tensor = None,  # (3,) source T-pose root position
    target_tpose_root: torch.Tensor = None,  # (3,)
    rotation_to_target: torch.Tensor = None,  # (4,) t_R_s frame alignment
    scale: float = None,
):
    """Returns (target_local_rot (F, Jt, 4), target_root_pos (F, 3)).

    The target skeleton's root must be a mapped joint (the parent walk for
    unmapped joints ends at a mapped ancestor); otherwise ValueError."""
    dev, dt = source_local_rot.device, source_local_rot.dtype
    F = source_local_rot.shape[0]
    Jt = target_tree.num_joints
    kw = dict(dtype=dt, device=dev)
    if source_tpose_rot is None:
        source_tpose_rot = quat.identity_like((source_tree.num_joints,), **kw)
    if target_tpose_rot is None:
        target_tpose_rot = quat.identity_like((Jt,), **kw)
    if source_tpose_root is None:
        source_tpose_root = torch.zeros((3,), **kw)
    if target_tpose_root is None:
        target_tpose_root = torch.zeros((3,), **kw)
    if scale is None:
        scale = _auto_leg_scale(source_tree, target_tree)

    src_tpose_g = forward_kinematics(source_tree, source_tpose_rot[None],
                                     source_tpose_root[None])[0][0]
    tgt_tpose_g = forward_kinematics(target_tree, target_tpose_rot[None],
                                     target_tpose_root[None])[0][0]
    src_g, _ = forward_kinematics(source_tree, source_local_rot,
                                  source_root_pos)
    src_root = source_root_pos
    src_tpose_root = source_tpose_root

    # frame alignment (skeleton3d.py:913-932 rotates the root rotation and
    # translation of both the state and the source T-pose)
    if rotation_to_target is not None:
        R = rotation_to_target
        src_g = quat.mul(R[None, None], src_g)
        src_tpose_g = quat.mul(R[None], src_tpose_g)
        src_root = quat.rotate(R[None], src_root)
        src_tpose_root = quat.rotate(R, src_tpose_root)

    tgt_g = tgt_tpose_g[None].repeat(F, 1, 1)
    mapped = set()
    for t_name, s_name in joint_map.items():
        ti = target_tree.index(t_name)
        si = source_tree.index(s_name)
        mapped.add(ti)
        delta = quat.mul(src_g[:, si], quat.conjugate(src_tpose_g[si][None]))
        tgt_g[:, ti] = quat.mul(delta, tgt_tpose_g[ti][None])

    for ti in range(Jt):
        a = ti
        while a not in mapped:
            a = int(target_tree.parents[a])
            if a < 0:
                raise ValueError("retarget_motion: the target root must be "
                                 "a mapped joint")
        if a != ti:
            tgt_g[:, ti] = tgt_g[:, a]

    target_local = local_from_global(target_tree, tgt_g)
    target_root_pos = (target_tpose_root[None]
                       + (src_root - src_tpose_root[None]) * scale)
    return target_local, target_root_pos
