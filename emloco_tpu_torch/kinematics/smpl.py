"""SMPL body model forward (linear blend skinning) on tensors.

Port of emloco_tpu/kinematics/smpl.py (the reference's SMPL_Parser,
uhc/smpllib/smpl_parser.py:258-495): given shape betas and a 72-d
axis-angle pose, the 24 joints and the skinned vertex mesh. The model file
(an SMPL npz with v_template, shapedirs, posedirs, J_regressor, weights and
kintree_table) is read into numpy; `get_joints_verts` runs on the device of
its inputs. Without a model file `capsule_surface` gives points on the
capsule bodies, in the world frame, as the mesh's stand-in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import quat
from . import body_model as bm
from .skeleton import forward_kinematics


@dataclasses.dataclass(frozen=True, eq=False)
class SMPLModel:
    v_template: np.ndarray           # (V, 3)
    shapedirs: np.ndarray            # (V, 3, K)
    posedirs: Optional[np.ndarray]   # (V, 3, 207) or None
    j_regressor: np.ndarray          # (24, V)
    lbs_weights: np.ndarray          # (V, 24)
    parents: np.ndarray              # (24,)

    @classmethod
    def load_npz(cls, path: str) -> "SMPLModel":
        d = np.load(path, allow_pickle=True)

        def get(k):
            return np.asarray(d[k], np.float32) if k in d else None

        pd = get("posedirs")
        if pd is not None and pd.ndim == 2:      # (V·3, 207) layout
            pd = pd.reshape(-1, 3, pd.shape[-1])
        return cls(
            v_template=get("v_template"),
            shapedirs=get("shapedirs"),
            posedirs=pd,
            j_regressor=get("J_regressor"),
            lbs_weights=get("weights"),
            parents=(np.asarray(d["kintree_table"])[0][:24].astype(np.int64)
                     if "kintree_table" in d else bm.PARENTS),
        )


def get_joints_verts(model: SMPLModel, pose_aa: torch.Tensor,
                     betas: torch.Tensor, trans: torch.Tensor = None):
    """LBS forward (smpl_parser.py:343-368): pose_aa (B, 72) axis-angle,
    betas (B, K), trans (B, 3) or None → (verts (B, V, 3), joints
    (B, 24, 3)). The shape blendshapes, the pose blendshapes of the
    rotation matrices' deviation from the identity (where the model has
    posedirs), FK with each sample's own rest offsets, then skinning
    v' = Σ_j w_j (R_j (v − j_rest_j) + g_j)."""
    dev, dt = pose_aa.device, pose_aa.dtype

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    B = pose_aa.shape[0]
    K = min(model.shapedirs.shape[-1], betas.shape[-1])
    v_shaped = t(model.v_template)[None] + torch.einsum(
        "vdk,bk->bvd", t(model.shapedirs[..., :K]), betas[:, :K])
    j_rest = torch.einsum("jv,bvd->bjd", t(model.j_regressor), v_shaped)

    rots = quat.exp_map_to_quat(pose_aa.reshape(B, 24, 3))     # (B,24,4)
    if model.posedirs is not None:
        R = quat.to_matrix(rots[:, 1:])                          # (B,23,3,3)
        feat = (R - torch.eye(3, dtype=dt, device=dev)).reshape(B, -1)
        v_shaped = v_shaped + torch.einsum("vdp,bp->bvd", t(model.posedirs),
                                           feat)

    parents = np.maximum(model.parents, 0)
    offsets = j_rest - j_rest[:, parents]
    offsets[:, 0] = 0.0
    grot, gpos = forward_kinematics(bm.canonical_skeleton(), rots,
                                    j_rest[:, 0], local_translation=offsets)

    rel = v_shaped[:, None] - j_rest[:, :, None]                 # (B,24,V,3)
    posed = quat.rotate(grot[:, :, None], rel) + gpos[:, :, None]
    verts = torch.einsum("vj,bjvd->bvd", t(model.lbs_weights), posed)
    if trans is not None:
        verts = verts + trans[:, None]
        gpos = gpos + trans[:, None]
    return verts, gpos


def capsule_surface(params: bm.BodyParams, body_pos, body_rot,
                    points_per_body: int = 8):
    """Pseudo-vertices: points_per_body points on each capsule in the world
    frame, spread along its axis at alternating radial offsets (the stand-in
    for the SMPL mesh, reference motion_lib_smpl.py:70-80). body_pos,
    body_rot: COM frames (N, 24, ·) → (N, 24·P, 3)."""
    P = points_per_body
    dev, dt = body_pos.device, body_pos.dtype
    ts = torch.as_tensor(np.linspace(-1.0, 1.0, P).astype(np.float32),
                         dtype=dt, device=dev)
    ax = params.capsule_axis[:, :, None] * (
        params.capsule_half[:, :, None, None] * ts[None, None, :, None])
    radial = np.stack([np.cos(np.arange(P) * 2.4),
                       np.sin(np.arange(P) * 2.4)], -1).astype(np.float32)
    rad = torch.cat([torch.as_tensor(radial, dtype=dt, device=dev),
                     torch.zeros((P, 1), dtype=dt, device=dev)], -1)
    offs = ax + params.capsule_radius[:, :, None, None] * rad[None, None]
    pts = body_pos[:, :, None] + quat.rotate(body_rot[:, :, None], offs)
    return pts.reshape(body_pos.shape[0], -1, 3)
