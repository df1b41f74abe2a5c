"""SMPL-parameterized humanoid body model → batched physics parameters.

Port of emloco_tpu/kinematics/body_model.py (the canonical 24-joint skeleton,
its tables, `build_body_params`, the MJCF export `to_mjcf` and
`from_smpl_npz`); the tables are kept here as a copy because the JAX module
imports jax and flax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..struct import TensorStruct
from .skeleton import SkeletonTree

BODY_NAMES = (
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe",
    "R_Hip", "R_Knee", "R_Ankle", "R_Toe",
    "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
)

PARENTS = np.array([
    -1, 0, 1, 2, 3,       # pelvis, left leg
    0, 5, 6, 7,           # right leg
    0, 9, 10, 11, 12,     # torso..head
    11, 14, 15, 16, 17,   # left arm (thorax from chest)
    11, 19, 20, 21, 22,   # right arm
], dtype=np.int64)

NUM_BODIES = len(BODY_NAMES)     # 24
NUM_JOINTS = NUM_BODIES - 1      # 23 actuated spherical joints
MESH_K = 6                       # collision spheres per body (mesh variant)
NUM_DOF = NUM_JOINTS * 3         # 69

# Mean-shape local joint offsets in parent frame (meters, z-up, x forward).
_MEAN_OFFSETS = np.array([
    [0.000,  0.000,  0.000],   # Pelvis (root)
    [0.000,  0.084, -0.073],   # L_Hip
    [0.000,  0.000, -0.386],   # L_Knee
    [0.000,  0.000, -0.415],   # L_Ankle
    [0.130,  0.000, -0.060],   # L_Toe
    [0.000, -0.084, -0.073],   # R_Hip
    [0.000,  0.000, -0.386],   # R_Knee
    [0.000,  0.000, -0.415],   # R_Ankle
    [0.130,  0.000, -0.060],   # R_Toe
    [0.000,  0.000,  0.113],   # Torso
    [0.000,  0.000,  0.131],   # Spine
    [0.000,  0.000,  0.055],   # Chest
    [0.000,  0.000,  0.212],   # Neck
    [0.000,  0.000,  0.090],   # Head
    [0.000,  0.072,  0.137],   # L_Thorax
    [0.000,  0.105,  0.000],   # L_Shoulder
    [0.000,  0.262,  0.000],   # L_Elbow
    [0.000,  0.249,  0.000],   # L_Wrist
    [0.000,  0.085,  0.000],   # L_Hand
    [0.000, -0.072,  0.137],   # R_Thorax
    [0.000, -0.105,  0.000],   # R_Shoulder
    [0.000, -0.262,  0.000],   # R_Elbow
    [0.000, -0.249,  0.000],   # R_Wrist
    [0.000, -0.085,  0.000],   # R_Hand
], dtype=np.float32)

_CAPSULE_RADIUS = np.array([
    0.115,                     # Pelvis
    0.070, 0.055, 0.045, 0.035,   # left leg
    0.070, 0.055, 0.045, 0.035,   # right leg
    0.105, 0.105, 0.110, 0.045, 0.095,  # torso..head
    0.055, 0.045, 0.035, 0.030, 0.030,  # left arm
    0.055, 0.045, 0.035, 0.030, 0.030,  # right arm
], dtype=np.float32)

_MASS_FRAC = np.array([
    0.1366,                          # Pelvis
    0.0700, 0.0465, 0.0130, 0.0020,  # left leg: thigh, shank, foot, toe
    0.0700, 0.0465, 0.0130, 0.0020,  # right leg
    0.0650, 0.0650, 0.1300, 0.0120, 0.0670,  # torso, spine, chest, neck, head
    0.0150, 0.0265, 0.0155, 0.0050, 0.0040,  # left arm
    0.0150, 0.0265, 0.0155, 0.0050, 0.0040,  # right arm
], dtype=np.float32)
_MASS_FRAC = _MASS_FRAC / _MASS_FRAC.sum()  # normalize to exactly 1

# (kp, kd, torque_limit) per joint
_PD_TABLE = {
    "L_Hip": (500, 50, 500), "L_Knee": (500, 50, 500),
    "L_Ankle": (400, 40, 500), "L_Toe": (200, 20, 500),
    "R_Hip": (500, 50, 500), "R_Knee": (500, 50, 500),
    "R_Ankle": (400, 40, 500), "R_Toe": (200, 20, 500),
    "Torso": (1000, 100, 500), "Spine": (1000, 100, 500),
    "Chest": (1000, 100, 500), "Neck": (100, 10, 250), "Head": (100, 10, 250),
    "L_Thorax": (400, 40, 500), "L_Shoulder": (400, 40, 500),
    "L_Elbow": (300, 30, 150), "L_Wrist": (100, 10, 150), "L_Hand": (100, 10, 150),
    "R_Thorax": (400, 40, 150), "R_Shoulder": (400, 40, 250),
    "R_Elbow": (300, 30, 150), "R_Wrist": (100, 10, 150), "R_Hand": (100, 10, 150),
}

# Symmetric per-axis joint limits (rad), upright variant.
_PI = np.pi
_JOINT_LIMITS = {
    "Head": (_PI / 2, _PI / 2, _PI / 2),
    "Chest": (_PI / 3, _PI / 3, _PI / 3),
    "Spine": (_PI / 3, _PI / 3, _PI / 3),
    "Torso": (_PI / 3, _PI / 3, _PI / 3),
    "Neck": (_PI / 2, _PI / 2, _PI / 2),
    "L_Thorax": (_PI, _PI, _PI), "R_Thorax": (_PI, _PI, _PI),
    "L_Shoulder": (_PI, _PI, _PI), "R_Shoulder": (_PI, _PI, _PI),
    "L_Elbow": (_PI / 2, _PI, _PI / 32), "R_Elbow": (_PI / 2, _PI, _PI / 32),
    "L_Wrist": (_PI / 2, _PI / 2, _PI / 2), "R_Wrist": (_PI / 2, _PI / 2, _PI / 2),
    "L_Hand": (_PI / 2, _PI / 2, _PI / 2), "R_Hand": (_PI / 2, _PI / 2, _PI / 2),
    "L_Hip": (_PI / 2, _PI / 2, _PI / 2), "R_Hip": (_PI / 2, _PI / 3, _PI / 3),
    "L_Knee": (_PI / 32, _PI, _PI / 32), "R_Knee": (_PI / 32, _PI, _PI / 32),
    "L_Ankle": (_PI / 4, _PI / 2, _PI / 4), "R_Ankle": (_PI / 4, _PI / 2, _PI / 4),
    "L_Toe": (_PI / 32, _PI / 2, _PI / 32), "R_Toe": (_PI / 32, _PI / 2, _PI / 32),
}

KEY_BODIES = ("R_Ankle", "L_Ankle", "R_Wrist", "L_Wrist")
CONTACT_BODIES = ("R_Ankle", "L_Ankle", "R_Toe", "L_Toe")

DEFAULT_HUMANOID_MASS = 77.0  # kg


def canonical_skeleton() -> SkeletonTree:
    return SkeletonTree(names=BODY_NAMES, parents=PARENTS,
                        local_translation=_MEAN_OFFSETS.copy())


@dataclasses.dataclass(frozen=True)
class BodyParams(TensorStruct):
    """Batched per-env physical parameters; every tensor leads with N."""

    local_offsets: torch.Tensor    # (N, 24, 3) rest offsets in parent frame
    capsule_radius: torch.Tensor   # (N, 24)
    capsule_half: torch.Tensor     # (N, 24)
    capsule_axis: torch.Tensor     # (N, 24, 3) unit, body frame
    capsule_start: torch.Tensor    # (N, 24, 3) segment start, body frame
    mass: torch.Tensor             # (N, 24)
    inv_mass: torch.Tensor         # (N, 24)
    inertia: torch.Tensor          # (N, 24, 3) principal, body frame
    inv_inertia: torch.Tensor      # (N, 24, 3)
    kp: torch.Tensor               # (N, 23)
    kd: torch.Tensor               # (N, 23)
    torque_limit: torch.Tensor     # (N, 23)
    joint_limit: torch.Tensor      # (N, 23, 3)
    betas: torch.Tensor            # (N, 16)
    height_offset: torch.Tensor    # (N,)
    friction_scale: torch.Tensor   # (N,)
    mesh_points: torch.Tensor = None        # (N, 24, MESH_K, 3)
    mesh_point_radius: torch.Tensor = None  # (N, 24, MESH_K)

    @property
    def num_envs(self) -> int:
        return self.local_offsets.shape[0]


def _bone_vectors(offsets: torch.Tensor) -> torch.Tensor:
    """Mean child offset per body; leaves get a nominal extent."""
    children = [[] for _ in range(NUM_BODIES)]
    for j in range(1, NUM_BODIES):
        children[PARENTS[j]].append(j)
    leaf_extent = {
        "L_Toe": [0.10, 0.0, 0.0], "R_Toe": [0.10, 0.0, 0.0],
        "Head": [0.0, 0.0, 0.14],
        "L_Hand": [0.0, 0.10, 0.0], "R_Hand": [0.0, -0.10, 0.0],
    }
    bones = []
    for b in range(NUM_BODIES):
        if children[b]:
            v = sum(offsets[..., c, :] for c in children[b]) / len(children[b])
        else:
            v = torch.as_tensor(
                leaf_extent[BODY_NAMES[b]], dtype=offsets.dtype,
                device=offsets.device).expand(offsets[..., b, :].shape)
        bones.append(v)
    return torch.stack(bones, dim=-2)


def build_body_params(betas, kp_scale: float = 1.0, kd_scale: float = 1.0,
                      total_mass: Optional[float] = None,
                      offsets_override=None, device=None) -> BodyParams:
    """betas (N, 16) → BodyParams (template shape space, as in the JAX
    package: beta[0] overall scale, beta[1] limb length, beta[2] girth, the
    rest a fixed small per-body projection). `offsets_override` (N, 24, 3)
    or (24, 3): parent-relative rest offsets of a real SMPL model
    (from_smpl_npz) in place of the scaled template's; every derived
    quantity is computed from them."""
    dev = _device.resolve(device)
    if isinstance(betas, torch.Tensor):
        betas = betas.to(device=dev, dtype=torch.float32)
    else:
        betas = torch.as_tensor(np.asarray(betas, np.float32), device=dev)
    if betas.dim() == 1:
        betas = betas[None]
    if betas.shape[-1] < 16:
        betas = torch.nn.functional.pad(betas, (0, 16 - betas.shape[-1]))
    N = betas.shape[0]
    B = NUM_BODIES
    f32 = dict(dtype=torch.float32, device=dev)

    overall = 1.0 + 0.05 * betas[:, 0:1]
    limb = 1.0 + 0.04 * betas[:, 1:2]
    girth = 1.0 + 0.06 * betas[:, 2:3]
    rng = np.random.RandomState(7)
    proj = torch.as_tensor(rng.randn(13, B).astype(np.float32) * 0.01, **f32)
    per_body = 1.0 + betas[:, 3:16] @ proj

    is_limb = np.array([n.startswith(("L_", "R_")) for n in BODY_NAMES])
    limb_scale = torch.where(torch.as_tensor(is_limb, device=dev)[None],
                             limb, torch.ones_like(limb))
    scale = overall * limb_scale * per_body
    if offsets_override is not None:
        offsets = torch.as_tensor(np.asarray(offsets_override, np.float32),
                                  device=dev)
        if offsets.dim() == 2:
            offsets = offsets[None]
        offsets = offsets.expand(N, B, 3).contiguous()
    else:
        offsets = torch.as_tensor(_MEAN_OFFSETS, **f32)[None] \
            * scale[..., None]

    bones = _bone_vectors(offsets)
    start = torch.zeros_like(offsets)
    for side in ("L_", "R_"):
        ankle = BODY_NAMES.index(side + "Ankle")
        toe = BODY_NAMES.index(side + "Toe")
        toe_off = offsets[:, toe]
        heel = torch.stack([-0.45 * torch.abs(toe_off[:, 0]),
                            torch.zeros_like(toe_off[:, 1]), toe_off[:, 2]],
                           dim=-1)
        start[:, ankle] = heel
        bones[:, ankle] = toe_off - heel
    bone_len = torch.linalg.norm(bones, dim=-1)
    axis = bones / torch.clamp(bone_len[..., None], min=1e-6)
    radius = torch.as_tensor(_CAPSULE_RADIUS, **f32)[None] * girth * overall
    half = torch.maximum(bone_len * 0.5, radius * 0.5)

    if total_mass is None:
        total_mass = DEFAULT_HUMANOID_MASS
    mass_scale = overall[:, 0] ** 3 * girth[:, 0]
    mass = (torch.as_tensor(_MASS_FRAC, **f32)[None] * total_mass
            * mass_scale[:, None])

    r2 = radius ** 2
    L = 2 * half
    i_axial = 0.5 * mass * r2
    i_trans = mass * (L ** 2 / 12.0 + r2 / 4.0)
    ax2 = axis ** 2
    inertia = ax2 * i_axial[..., None] + (1 - ax2) * i_trans[..., None]
    inertia = torch.clamp(inertia, min=1e-4)

    kp = torch.as_tensor([_PD_TABLE[n][0] for n in BODY_NAMES[1:]], **f32)
    kd = torch.as_tensor([_PD_TABLE[n][1] for n in BODY_NAMES[1:]], **f32)
    tl = torch.as_tensor([_PD_TABLE[n][2] for n in BODY_NAMES[1:]], **f32)
    pd_scale = (mass.sum(-1) / DEFAULT_HUMANOID_MASS)[:, None]
    kp = kp[None] * pd_scale * kp_scale
    kd = kd[None] * pd_scale * kd_scale
    tl = tl[None].expand(N, NUM_JOINTS).contiguous()
    jl = torch.as_tensor([_JOINT_LIMITS[n] for n in BODY_NAMES[1:]], **f32)
    jl = jl[None].expand(N, NUM_JOINTS, 3).contiguous()

    # rest pelvis height: pivot to the lowest capsule surface point in the
    # identity pose
    pivot_z = [offsets[:, 0, 2] * 0.0]
    for b in range(1, B):
        pivot_z.append(pivot_z[PARENTS[b]] + offsets[:, b, 2])
    pivot_z = torch.stack(pivot_z, dim=-1)
    seg0_z = pivot_z + start[..., 2]
    bone_z = 2.0 * half * axis[..., 2]
    end_lo = torch.minimum(seg0_z, seg0_z + bone_z) - radius
    height_offset = -torch.min(end_lo, dim=-1).values + 0.01

    ts = torch.linspace(-1.0, 1.0, MESH_K, **f32)
    mesh_points = (axis[:, :, None, :]
                   * (half[:, :, None] * ts[None, None, :])[..., None])
    mesh_radius = radius[:, :, None].expand(N, B, MESH_K).contiguous()

    return BodyParams(
        local_offsets=offsets, capsule_radius=radius, capsule_half=half,
        capsule_axis=axis, capsule_start=start, mesh_points=mesh_points,
        mesh_point_radius=mesh_radius, mass=mass, inv_mass=1.0 / mass,
        inertia=inertia, inv_inertia=1.0 / inertia, kp=kp, kd=kd,
        torque_limit=tl, joint_limit=jl, betas=betas,
        height_offset=height_offset,
        friction_scale=torch.ones((N,), **f32),
    )


# the fields of one env's row that to_mjcf writes, in the order they are
# gathered for the one host copy
_MJCF_FIELDS = ("local_offsets", "capsule_start", "capsule_axis",
                "capsule_half", "capsule_radius", "joint_limit", "kp", "kd",
                "torque_limit", "height_offset")


def to_mjcf(params: BodyParams, env_idx: int = 0,
            model_name: str = "emloco_humanoid") -> str:
    """Export one env's body as a MuJoCo MJCF XML string: a capsule geom per
    body, each spherical joint as three hinges with their ranges, a motor
    per hinge geared by the joint's torque limit. The same string as the
    JAX package's for the same parameters. The env's row is copied to the
    host once, on any device, and written from numpy."""
    import xml.etree.ElementTree as ET

    row = [getattr(params, f)[env_idx] for f in _MJCF_FIELDS]
    flat = torch.cat([t.reshape(-1) for t in row]).cpu().numpy()
    parts = np.split(flat, np.cumsum([t.numel() for t in row])[:-1])
    (off, start, axis, half, radius, lim, kp, kd, tl, h0) = (
        p.reshape(tuple(t.shape)) for p, t in zip(parts, row))

    root = ET.Element("mujoco", model=model_name)
    ET.SubElement(root, "option", timestep="0.016667", gravity="0 0 -9.81")
    worldbody = ET.SubElement(root, "worldbody")
    actuators = ET.SubElement(root, "actuator")

    nodes = {}
    for b, name in enumerate(BODY_NAMES):
        parent_el = worldbody if PARENTS[b] < 0 else nodes[PARENTS[b]]
        pos = off[b] if b > 0 else np.array([0.0, 0.0, float(h0)])
        body = ET.SubElement(parent_el, "body", name=name,
                             pos=" ".join(f"{v:.5f}" for v in pos))
        nodes[b] = body
        if b == 0:
            ET.SubElement(body, "freejoint", name="root")
        else:
            j = b - 1
            for ax_i, ax_v in enumerate(("1 0 0", "0 1 0", "0 0 1")):
                hinge = f"{name}_{'xyz'[ax_i]}"
                ET.SubElement(
                    body, "joint", name=hinge, type="hinge", axis=ax_v,
                    damping=f"{kd[j]:.3f}", stiffness="0",
                    range=f"{-lim[j, ax_i]:.4f} {lim[j, ax_i]:.4f}")
                ET.SubElement(actuators, "motor", name=hinge, joint=hinge,
                              gear=f"{tl[j]:.1f}")
        p0 = start[b]
        p1 = start[b] + 2 * half[b] * axis[b]
        ET.SubElement(
            body, "geom", type="capsule", size=f"{radius[b]:.5f}",
            fromto=" ".join(f"{v:.5f}" for v in np.concatenate([p0, p1])))
    ET.indent(root)
    return ET.tostring(root, encoding="unicode")


def from_smpl_npz(path: str, betas, device=None, **kw) -> BodyParams:
    """BodyParams from an SMPL model file (v_template, shapedirs,
    J_regressor and, where present, skinning weights), as the JAX package
    builds them: the regressor's joints of the beta-shaped template, turned
    z-up upright, give the parent-relative offsets; with skinning weights
    each body's mesh colliders are fit to its vertices (owner = the argmax
    weight): MESH_K vertices picked by farthest-point sampling on env 0,
    each a tangent sphere with its centre at γ·v in the COM frame and radius
    (1 − γ)·‖v‖, γ = 0.8. A body owning no vertex keeps the capsule
    spheres."""
    data = np.load(path, allow_pickle=True)
    v_template = np.asarray(data["v_template"], np.float32)        # (V,3)
    shapedirs = np.asarray(data["shapedirs"], np.float32)          # (V,3,K)
    j_reg = np.asarray(data["J_regressor"], np.float32)            # (24,V)
    betas_np = np.asarray(betas, np.float32)
    if betas_np.ndim == 1:
        betas_np = betas_np[None]
    K = min(shapedirs.shape[-1], betas_np.shape[-1])
    v = v_template[None] + np.einsum("vdk,nk->nvd", shapedirs[..., :K],
                                     betas_np[:, :K])
    joints = np.einsum("jv,nvd->njd", j_reg, v)                    # y-up
    # SMPL's y-up, +z forward → z-up, +x forward
    R = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    joints = joints @ R.T
    offsets = joints.copy()
    offsets[:, 0] = 0.0
    for j in range(1, NUM_BODIES):
        offsets[:, j] = joints[:, j] - joints[:, PARENTS[j]]
    bp = build_body_params(betas_np, offsets_override=offsets, device=device,
                           **kw)

    wkey = "weights" if "weights" in data else "lbs_weights"
    if wkey not in data:
        return bp
    w = np.asarray(data[wkey], np.float32)                         # (V,24)
    verts = v @ R.T                                                # z-up
    owner = np.argmax(w, axis=-1)
    com_off = (bp.capsule_start
               + bp.capsule_axis * bp.capsule_half[..., None]).cpu().numpy()
    com_rest = joints + com_off                                    # (N,24,3)
    gamma = 0.8
    n = verts.shape[0]
    centers = np.zeros((n, NUM_BODIES, MESH_K, 3), np.float32)
    radii = np.zeros((n, NUM_BODIES, MESH_K), np.float32)
    mesh_points = bp.mesh_points.cpu().numpy()
    mesh_radius = bp.mesh_point_radius.cpu().numpy()
    for b in range(NUM_BODIES):
        sel = np.nonzero(owner == b)[0]
        if sel.size == 0:
            centers[:, b] = mesh_points[:, b]
            radii[:, b] = mesh_radius[:, b]
            continue
        loc0 = verts[0, sel] - com_rest[0, b]
        picks = [int(np.argmax(np.linalg.norm(loc0, axis=-1)))]
        d = np.linalg.norm(loc0 - loc0[picks[0]], axis=-1)
        while len(picks) < MESH_K:
            picks.append(int(np.argmax(d)))
            d = np.minimum(d, np.linalg.norm(loc0 - loc0[picks[-1]],
                                             axis=-1))
        vloc = verts[:, sel[picks]] - com_rest[:, b:b + 1]        # (N,K,3)
        centers[:, b] = gamma * vloc
        radii[:, b] = (1.0 - gamma) * np.linalg.norm(vloc, axis=-1)
    dev = bp.mass.device
    return bp.replace(mesh_points=torch.as_tensor(centers, device=dev),
                      mesh_point_radius=torch.as_tensor(radii, device=dev))
