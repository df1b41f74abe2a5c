"""Reduced-coordinate articulated dynamics — the engine core.

Port of emloco_tpu/physics/reduced.py. Two control steps, as in the JAX
engine:
  - the TGS step (`_tgs_step`, the default) builds the merged Jacobian rows
    and the contact set once, assembles the 75×75 implicit system, factors
    it once with the block-arrow kernel and re-solves it every substep;
  - the implicit substep (`_implicit_substep`, `tgs_step=False` or
    `n_substeps=1`) re-assembles and solves the system every substep, with
    the fused block-arrow or the dense Cholesky kernel.
Either assembles env-last (75, 75, N) or, with `batch_major_solver`,
batch-major (N, 75, 75) for the block-arrow kernels' batch-major entry
points, as one weighted Gram of the merged rows: single-operand √w (the
default), two-operand (`sqrt_gram=False`, or when a weight can be
negative), or the `gram_diag` kernel (`gram_kernel`). Per substep the engine
solves

    A u⁺ = M u + dt·(Q_gravity + Q_bias + Q_spring + Q_contact_explicit)

with Stable-PD drives and implicit spring-damper contacts folded into A.

Contact rows come from one of two ground tables, the capsule end-spheres
(28 points, the default) or the mesh colliders (`mesh_contacts`: MESH_K
spheres on each of the 14 contact bodies, 84 points), each looked up in the
global corner texture or in a per-env window of it (`terrain_patch`); with
`self_contact` the 24 capsule pairs of _SELF_PAIR_NAMES add relative rows
whose linear columns cancel. The merged row count M is 256 (capsule), 352
(capsule + self), 480 (mesh) or 576 (mesh + self).

Generalized coordinates (75 DOF): u = [v_root (3, world), ω_root (3,
world), qd_1..23 (world-frame relative joint angular velocities)].
Positions: root COM position, root rotation, 23 relative joint quaternions.

Layouts follow the JAX engine so tests compare like with like: the LHS is
emitted env-last (75, 75, N) and the right-hand side (75, N), or (N, 75, 75)
and (N, 75) batch-major. The 4-D functions (`_build_jacobians` and the
others of that section) are the oracle the merged rows are held against in
the tests, as in the JAX engine.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..kinematics import body_model as bm
from ..kinematics.skeleton import forward_kinematics
from ..ops import quat
from ..struct import TensorStruct
from ..utils.profiling import annotate
from .linalg import (arrow_pattern, cholesky_factor_blocked,
                     cholesky_factor_blocked_t,
                     cholesky_resolve_blocked, cholesky_resolve_blocked_t,
                     cholesky_solve_blocked, cholesky_solve_blocked_t,
                     cholesky_solve_soa_t, gram_diag, to_env_last)
from .terrain import (Heightfield, corner_patch, height_and_normal_at,
                      height_and_normal_at_patch)
from .types import EngineConfig

B = bm.NUM_BODIES            # 24
NJ = B - 1                   # 23 spherical joints
NU = 6 + 3 * NJ              # 75
PARENTS = bm.PARENTS
NA = 3 * (NJ + 1)            # 72 angular generalized-velocity columns
MROWS = 3 * B                # 72 merged body rows (m = 3k + i)


# ---------------------------------------------------------------------------
# Static scaffolding (numpy, built once; copied from the JAX engine)
# ---------------------------------------------------------------------------

def _subtree_masks(parents: np.ndarray) -> np.ndarray:
    sub = np.zeros((len(parents) - 1, len(parents)), np.float32)
    for j in range(1, len(parents)):
        stack = [j]
        while stack:
            b = stack.pop()
            sub[j - 1, b] = 1.0
            stack.extend([k for k in range(len(parents)) if parents[k] == b])
    return sub


def _arrow_blocks(parents: np.ndarray = PARENTS):
    """Block-arrow structure of the reduced-coordinate system matrix.

    M[i,j] ≠ 0 only for DoFs on a common root-to-leaf path, so with DoFs
    ordered [limb chains | shared trunk + root] the matrix is block-arrow and
    its Cholesky has zero fill-in. Returns (chunks, limbs, s_lo): old DoF
    ranges in new order, the dense limb blocks in new coordinates, and the
    start of the shared block. Derived from the tree, not hard-coded."""
    n = len(parents)
    kids = {i: [] for i in range(n)}
    for i in range(1, n):
        kids[int(parents[i])].append(i)
    shared = set()
    for b in range(n):
        if len(kids[b]) >= 2:
            a = b
            while a != -1:
                shared.add(a)
                a = int(parents[a])
    comp_id, comps = {}, []
    for b in range(1, n):
        if b in shared:
            continue
        p = int(parents[b])
        if p in comp_id:
            cid = comp_id[p]
        else:
            cid = len(comps)
            comps.append([])
        comp_id[b] = cid
        comps[cid].append(b)

    def dof_ranges(bodies):
        out = []
        for b in sorted(bodies):
            lo, hi = 6 + 3 * (b - 1), 6 + 3 * b
            if out and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi)
            else:
                out.append((lo, hi))
        return out

    chunks, limbs, off = [], [], 0
    for comp in comps:
        chunks += dof_ranges(comp)
        limbs.append((off, off + 3 * len(comp)))
        off += 3 * len(comp)
    s_lo = off
    chunks += dof_ranges([b for b in sorted(shared) if b != parents[0] + 1
                          and b != 0])
    chunks.append((0, 6))                       # root last
    return tuple(chunks), tuple(limbs), s_lo


_SUB = _subtree_masks(PARENTS)                    # (23, 24)
_ARROW_CHUNKS, _ARROW_LIMBS, _ARROW_S = _arrow_blocks()
_SUBX = np.concatenate([np.ones((1, B), np.float32), _SUB], 0)   # (24, 24)

# JW_EXT[k, j, c] = 1 where angular column c (root-ang a=0, joints a=1..23)
# contributes ω_j to body k: c = 3·a + j for every ancestor a of k
_JW_EXT = np.zeros((B, 3, NA), np.float32)
for _k in range(B):
    for _a in range(NJ + 1):
        if _SUBX[_a, _k] > 0:
            for _j in range(3):
                _JW_EXT[_k, _j, 3 * _a + _j] = 1.0
_COL_EXT = np.zeros((NJ + 1, 3, NA), np.float32)
for _a in range(NJ + 1):
    for _j in range(3):
        _COL_EXT[_a, _j, 3 * _a + _j] = 1.0


def _eps_fold(sel):
    """sel (K, 3, C) one-hot column selector → E (K, 3, 3, C) such that
    Σ_j r_j·E[k, j, i, c] == (−[r]× @ sel[k])[i, c]."""
    K, _, C = sel.shape
    out = np.zeros((K, 3, 3, C), np.float32)
    terms = {(0, 1): (2, 1.0), (0, 2): (1, -1.0),
             (1, 0): (2, -1.0), (1, 2): (0, 1.0),
             (2, 0): (1, 1.0), (2, 1): (0, -1.0)}
    for (i, l), (j, sgn) in terms.items():
        out[:, j, i, :] += sgn * sel[:, l, :]
    return out


_EPS_JW = _eps_fold(_JW_EXT)                      # (B,3,3,72)
_EPS_COL = _eps_fold(_COL_EXT)                    # (24ext,3,3,72)

# merged-row statics: G = [x | pivots]·_G_M, t2m = pivots·_F_M, W via _TW_M
_E1_M = np.zeros((B, 3, MROWS, NA), np.float32)
for _k in range(B):
    _E1_M[_k, :, 3 * _k:3 * _k + 3, :] = _EPS_JW[_k]
_F_M = np.ascontiguousarray(
    np.einsum("ak,ajic->ajkic", _SUBX, -_EPS_COL)
    .reshape(NJ + 1, 3, MROWS, NA).astype(np.float32))
_TW_M = np.zeros((B, 3, 3, MROWS, NA), np.float32)
for _k in range(B):
    for _i in range(3):
        _TW_M[_k, :, _i, 3 * _k + _i, :] = _JW_EXT[_k]
_G_M = np.concatenate([_E1_M, _F_M], axis=0)             # (48, 3, 72, 72)
_ISEL_M = np.tile(np.eye(3, dtype=np.float32), (B, 1))   # (72, 3)

# ground-contact sample table: capsule end-spheres of the bodies that can
# touch the ground
_CONTACT_BODY_NAMES = (
    "Pelvis", "Torso", "Chest", "Head",
    "L_Knee", "R_Knee", "L_Ankle", "R_Ankle", "L_Toe", "R_Toe",
    "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist",
)
_CONTACT_BODY = np.repeat(
    np.array([bm.BODY_NAMES.index(n) for n in _CONTACT_BODY_NAMES]), 2)
_CONTACT_END = np.tile(np.array([0, 1]), len(_CONTACT_BODY_NAMES))
_CONTACT_ONEHOT = np.eye(B, dtype=np.float32)[_CONTACT_BODY]
NC = len(_CONTACT_BODY)
RC = 3 * NC

# self-contact: capsule pairs where fall and getup interpenetration shows
# (forearms and hands against the trunk, legs crossing); adjacent bodies
# share a pivot and are left out
_SELF_PAIR_NAMES = (
    ("L_Elbow", "Pelvis"), ("L_Elbow", "Torso"), ("L_Elbow", "Chest"),
    ("R_Elbow", "Pelvis"), ("R_Elbow", "Torso"), ("R_Elbow", "Chest"),
    ("L_Wrist", "Pelvis"), ("L_Wrist", "Torso"), ("L_Wrist", "Chest"),
    ("R_Wrist", "Pelvis"), ("R_Wrist", "Torso"), ("R_Wrist", "Chest"),
    ("L_Hand", "Pelvis"), ("L_Hand", "Torso"), ("L_Hand", "Chest"),
    ("R_Hand", "Pelvis"), ("R_Hand", "Torso"), ("R_Hand", "Chest"),
    ("L_Wrist", "L_Hip"), ("R_Wrist", "R_Hip"),
    ("L_Knee", "R_Knee"), ("L_Ankle", "R_Ankle"),
    ("L_Knee", "R_Hip"), ("R_Knee", "L_Hip"),
)
_SELF_A = np.array([bm.BODY_NAMES.index(a) for a, _ in _SELF_PAIR_NAMES])
_SELF_B = np.array([bm.BODY_NAMES.index(b) for _, b in _SELF_PAIR_NAMES])
NSELF = len(_SELF_PAIR_NAMES)
# signed map: +F on body A, −F reaction on body B
_SELF_ONEHOT = (np.eye(B, dtype=np.float32)[_SELF_A]
                - np.eye(B, dtype=np.float32)[_SELF_B])
# (+ε[A], −ε[B]) stacked: the pair-difference Jacobian in one contraction
_SELF_EPS = np.stack([_EPS_JW[_SELF_A], -_EPS_JW[_SELF_B]],
                     axis=1).astype(np.float32)          # (K,2,3,3,72)


def _self_rows_fit_arrow() -> bool:
    """Whether every self pair's rows keep the LHS inside the block-arrow
    pattern. A pair's relative row spans the DoFs of both bodies' chains
    (and the root's); when those are two limbs (a wrist and a hip, the two
    legs) its outer product fills the limb-limb block, which the block-arrow
    factor and solves never read. The JAX engine's Pallas path solves that
    system without those entries; its CPU path, the reference of the
    tests, solves it whole."""
    perm = np.concatenate([np.arange(lo, hi) for lo, hi in _ARROW_CHUNKS])
    keep = arrow_pattern(_ARROW_LIMBS, _ARROW_S, NU)
    keep = keep | keep.T
    for a, b in zip(_SELF_A, _SELF_B):
        dof = np.zeros(NU, bool)
        dof[:6] = True
        for j in range(1, NJ + 1):
            if _SUBX[j, a] or _SUBX[j, b]:
                dof[6 + 3 * (j - 1):6 + 3 * j] = True
        dof = dof[perm]
        if (np.outer(dof, dof) & ~keep).any():
            return False
    return True


SELF_ROWS_FIT_ARROW = _self_rows_fit_arrow()     # False: 6 pairs span limbs

# mesh-collider ground table: the same contact bodies, MESH_K spheres each
# from BodyParams.mesh_points
_MESH_BODY_U = np.array([bm.BODY_NAMES.index(n) for n in _CONTACT_BODY_NAMES])
_MESH_BODY = np.repeat(_MESH_BODY_U, bm.MESH_K)
_MESH_ONEHOT = np.eye(B, dtype=np.float32)[_MESH_BODY]
NC_MESH = len(_MESH_BODY)

_TABLE_BODY = {"capsule": _CONTACT_BODY, "mesh": _MESH_BODY}


@functools.lru_cache(maxsize=None)
def _merged_point_statics(bodies_key: str):
    """The JAX engine's static tensors of a contact table's merged point
    rows, as numpy: (E1C, OH, P, FLC, ISELC) with
      E1C (C,3,RC,72) −[pt]×·JW folded per row block ((C,2,3,RC,72) for
                      "self", the A side and the B side negated);
      OH  (RC,72)     row r → merged body row 3·body(r//3) + r%3 (signed
                      for "self": +A, −B);
      P   (C,RC)      per-contact sum over its 3 rows;
      FLC (C,3,RC)    (N,C,3) → (N,RC) one-hot merger;
      ISELC (RC,3)    row → xyz selector.
    The port's row functions index with `_table_statics` instead; the tests
    hold both against JAX's."""
    if bodies_key == "self":
        C = NSELF
        RCn = 3 * C
        E1C = np.zeros((C, 2, 3, RCn, NA), np.float32)
        OH = np.zeros((RCn, MROWS), np.float32)
        for ci in range(C):
            E1C[ci, 0, :, 3 * ci:3 * ci + 3, :] = _EPS_JW[_SELF_A[ci]]
            E1C[ci, 1, :, 3 * ci:3 * ci + 3, :] = -_EPS_JW[_SELF_B[ci]]
        for r in range(RCn):
            OH[r, 3 * _SELF_A[r // 3] + r % 3] += 1.0
            OH[r, 3 * _SELF_B[r // 3] + r % 3] -= 1.0
    else:
        bodies = _TABLE_BODY[bodies_key]
        C = len(bodies)
        RCn = 3 * C
        E1C = np.zeros((C, 3, RCn, NA), np.float32)
        OH = np.zeros((RCn, MROWS), np.float32)
        for ci in range(C):
            E1C[ci, :, 3 * ci:3 * ci + 3, :] = _EPS_JW[bodies[ci]]
        for r in range(RCn):
            OH[r, 3 * bodies[r // 3] + r % 3] = 1.0
    P = np.zeros((C, RCn), np.float32)
    FLC = np.zeros((C, 3, RCn), np.float32)
    for ci in range(C):
        P[ci, 3 * ci:3 * ci + 3] = 1.0
        for i in range(3):
            FLC[ci, i, 3 * ci + i] = 1.0
    ISELC = np.tile(np.eye(3, dtype=np.float32), (C, 1))
    return E1C, OH, P, FLC, ISELC


def _rows_of(bodies):
    """Merged body row 3·body(r//3) + r%3 of each point row r."""
    return np.array([3 * bodies[r // 3] + r % 3
                     for r in range(3 * len(bodies))])


@functools.lru_cache(maxsize=None)
def _table_statics(table: str, device: torch.device):
    """A row table's statics on `device`: `eps`, the ε-folded −[pt]×·JW of
    each point, (C,3,3,72), or of each pair's two sides, (K,2,3,3,72) for
    "self"; `row`, the merged body row each point row reads in t2m (for
    "self" `row_a` and `row_b`, A's and B's: the OH selection as an index);
    `iselc`, the row → xyz selector (3C,3); `onehot`, the row → body map of
    the force readback (C,24), signed for "self"; `body` (and for "self"
    `body_b`), the body of each point."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    if table == "self":
        out = dict(eps=t(_SELF_EPS), row_a=t(_rows_of(_SELF_A), torch.long),
                   row_b=t(_rows_of(_SELF_B), torch.long),
                   onehot=t(_SELF_ONEHOT), body=t(_SELF_A, torch.long),
                   body_b=t(_SELF_B, torch.long))
        C = NSELF
    else:
        bodies = _TABLE_BODY[table]
        C = len(bodies)
        out = dict(eps=t(_EPS_JW[bodies]), row=t(_rows_of(bodies), torch.long),
                   onehot=t(np.eye(B, dtype=np.float32)[bodies]),
                   body=t(bodies, torch.long))
    out["iselc"] = t(np.tile(np.eye(3, dtype=np.float32), (C, 1)))
    return out


@functools.lru_cache(maxsize=None)
def _statics(device: torch.device):
    """The numpy scaffolding as tensors on `device`, flattened for matmuls."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    parent = np.maximum(PARENTS, 0)
    return dict(
        sub=t(_SUB),
        subx=t(_SUBX),
        jw=t(_JW_EXT.reshape(MROWS, NA)),
        jw3=t(_JW_EXT),
        eps_jw=t(_EPS_JW),
        eps_col=t(_EPS_COL),
        g_m=t(_G_M.reshape(2 * B * 3, MROWS * NA)),
        f_m=t(_F_M.reshape((NJ + 1) * 3, MROWS * NA)),
        tw_m=t(_TW_M.reshape(B * 9, MROWS * NA)),
        isel=t(_ISEL_M),
        contact_end=t(_CONTACT_END, torch.long),
        mesh_body_u=t(_MESH_BODY_U, torch.long),
        parent=t(parent, torch.long),
        parent_j=t(parent[1:], torch.long),
        eye=torch.eye(NU, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# State and model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhysicsState(TensorStruct):
    """Reduced-coordinate state + maximal-coordinate body cache (COM
    frames; body_frame_state gives the joint-pivot frames)."""

    root_pos: torch.Tensor      # (N, 3) root COM position
    root_rot: torch.Tensor      # (N, 4)
    joint_rot: torch.Tensor     # (N, 23, 4) relative quats (child in parent)
    u: torch.Tensor             # (N, 75) generalized velocity
    body_x: torch.Tensor        # (N, 24, 3) COM positions
    body_q: torch.Tensor        # (N, 24, 4)
    body_v: torch.Tensor        # (N, 24, 3) COM velocities
    body_w: torch.Tensor        # (N, 24, 3) angular velocities
    contact_force: torch.Tensor  # (N, 24, 3)

    @property
    def num_envs(self):
        return self.root_pos.shape[0]


@dataclasses.dataclass(frozen=True)
class Model(TensorStruct):
    """Engine-ready batched body data derived from BodyParams."""

    params: bm.BodyParams
    com_off: torch.Tensor       # (N,B,3) capsule center in the pivot frame
    anchor_c: torch.Tensor      # (N,B,3) own pivot in the COM frame

    @property
    def num_envs(self):
        return self.com_off.shape[0]


def build_model(params: bm.BodyParams) -> Model:
    com_off = (params.capsule_start
               + params.capsule_axis * params.capsule_half[..., None])
    return Model(params=params, com_off=com_off, anchor_c=-com_off)


@functools.lru_cache(maxsize=None)
def default_tree():
    return bm.canonical_skeleton()


# ---------------------------------------------------------------------------
# Kinematics: reduced state → body frames
# ---------------------------------------------------------------------------

def root_pos_pivot_from_com(model: Model, root_com, root_rot):
    """Root state is stored as COM; FK wants the pelvis pivot."""
    return root_com - quat.rotate(root_rot, model.com_off[:, 0])


def _fk(model: Model, root_pos, root_rot, joint_rot, tree):
    local_rot = torch.cat([root_rot[:, None], joint_rot], dim=1)
    grot, gpos_pivot = forward_kinematics(
        tree, local_rot, root_pos_pivot_from_com(model, root_pos, root_rot),
        local_translation=model.params.local_offsets)
    x = gpos_pivot + quat.rotate(grot, model.com_off)
    return x, grot, gpos_pivot


def _body_velocities(model: Model, x, grot, gpos_pivot, u):
    """u → per-body COM velocity and angular velocity (cross products
    distributed, as in the JAX engine)."""
    sub = _statics(u.device)["sub"]
    v_root = u[:, 0:3]
    w_root = u[:, 3:6]
    qd = u[:, 6:].reshape(-1, NJ, 3)
    w_sum = torch.einsum("jb,nji->nbi", sub, qd)
    w_b = w_root[:, None] + w_sum
    x0 = x[:, 0:1]
    piv = gpos_pivot[:, 1:]
    v_b = v_root[:, None] + quat.cross(w_root[:, None], x - x0)
    qdxp = quat.cross(qd, piv)
    v_b = (v_b + quat.cross(w_sum, x)
           - torch.einsum("jb,nji->nbi", sub, qdxp))
    return v_b, w_b


def refresh_cache(model: Model, state: PhysicsState, tree) -> PhysicsState:
    x, grot, gpos_pivot = _fk(model, state.root_pos, state.root_rot,
                              state.joint_rot, tree)
    v_b, w_b = _body_velocities(model, x, grot, gpos_pivot, state.u)
    return state.replace(body_x=x, body_q=grot, body_v=v_b, body_w=w_b)


def kinematic_state(model: Model, tree, root_pos, root_rot, local_rot,
                    root_vel=None, root_ang_vel=None,
                    dof_vel=None) -> PhysicsState:
    """Pose the articulation kinematically: root_pos is the pelvis PIVOT,
    local_rot (N,24,4) includes the root at index 0, dof_vel (N,23,3) is in
    the parent frame."""
    N = root_pos.shape[0]
    z = dict(dtype=root_pos.dtype, device=root_pos.device)
    root_rot = quat.normalize(root_rot)
    joint_rot = quat.normalize(local_rot[:, 1:])
    root_com = root_pos + quat.rotate(root_rot, model.com_off[:, 0])
    if root_vel is None:
        root_vel = torch.zeros((N, 3), **z)
    if root_ang_vel is None:
        root_ang_vel = torch.zeros((N, 3), **z)
    if dof_vel is None:
        dof_vel = torch.zeros((N, NJ, 3), **z)

    x, grot, gpos_pivot = _fk(model, root_com, root_rot, joint_rot, tree)
    parent = _statics(root_pos.device)["parent_j"]
    qd = quat.rotate(grot[:, parent], dof_vel)
    r = quat.rotate(root_rot, model.com_off[:, 0])
    v_com = root_vel + quat.cross(root_ang_vel, r)
    u = torch.cat([v_com, root_ang_vel, qd.reshape(N, -1)], dim=-1)
    v_b, w_b = _body_velocities(model, x, grot, gpos_pivot, u)
    return PhysicsState(root_pos=root_com, root_rot=root_rot,
                        joint_rot=joint_rot, u=u, body_x=x, body_q=grot,
                        body_v=v_b, body_w=w_b,
                        contact_force=torch.zeros((N, B, 3), **z))


def body_frame_state(model: Model, state: PhysicsState):
    """COM cache → joint-pivot (rigid-body) states: (pos, rot, vel, ang)."""
    r = quat.rotate(state.body_q, model.com_off)
    pos = state.body_x - r
    vel = state.body_v + quat.cross(state.body_w, -r)
    return pos, state.body_q, vel, state.body_w


def joint_state(model: Model, state: PhysicsState):
    """dof_pos: exp-map of the relative joint rotations (N,23,3); dof_vel:
    relative angular velocity in the parent frame (N,23,3)."""
    dof_pos = quat.to_exp_map(state.joint_rot)
    parent = _statics(state.u.device)["parent_j"]
    qp = state.body_q[:, parent]
    qd = state.u[:, 6:].reshape(-1, NJ, 3)
    return dof_pos, quat.rotate_inv(qp, qd)


# ---------------------------------------------------------------------------
# Row-merged Jacobians and assembly
# ---------------------------------------------------------------------------

def _flat_dot(a, w, rows, cols):
    """(N, K) @ (K, rows·cols) → (N, rows, cols) in float32."""
    return (a.reshape(a.shape[0], -1) @ w).reshape(a.shape[0], rows, cols)


def _build_rows_merged(model: Model, x, q, pivots_x, out_dtype):
    """G (N,72,72) angular Jv rows, W (N,72,72) inertia rows √D·RᵀJw, t2m
    (N,72,72) the shared pivot contraction; each accumulated in float32 and
    stored in `out_dtype`."""
    s = _statics(x.device)
    N = x.shape[0]
    xp = torch.cat([x, pivots_x], dim=1)                  # (N, 48, 3)
    G = _flat_dot(xp, s["g_m"], MROWS, NA).to(out_dtype)
    t2m = _flat_dot(pivots_x, s["f_m"], MROWS, NA).to(out_dtype)
    R = quat.to_matrix(q)                                 # (N, B, 3, 3)
    sD = torch.sqrt(model.params.inertia).reshape(N, MROWS)
    W = (sD[..., None] * _flat_dot(R, s["tw_m"], MROWS, NA)).to(out_dtype)
    return G, W, t2m


def _point_rows_merged(points, table: str, t2m):
    """Merged angular point-Jacobian rows Gc (N,3C,72) of the world points
    of `table` (their linear block is an implicit identity per row triple).
    For "self", `points` is (N,K,2,3) [cA, cB] and the rows are the
    relative pair Jacobian, whose linear block is exactly zero. The
    −[pt]×·JW part picks one signed point coordinate per entry (exact in
    any order); the pivot part selects t2m's rows (for "self" A's minus
    B's, in float32, then rounded to the row dtype, as the JAX engine's
    signed one-hot contraction rounds it)."""
    s = _table_statics(table, points.device)
    if table == "self":
        t1 = torch.einsum("ncsj,csjid->ncid", points, s["eps"])
        piv = (t2m[:, s["row_a"]].float()
               - t2m[:, s["row_b"]].float()).to(t2m.dtype)
    else:
        t1 = torch.einsum("ncj,cjid->ncid", points, s["eps"])
        piv = t2m[:, s["row"]]
    N, C = t1.shape[:2]
    return t1.reshape(N, 3 * C, NA).to(t2m.dtype) + piv


def _normal_rows_merged(nrm, Gc):
    """Jn_ang (N,C,72): Σ_i n_i·Gc[3c+i] per contact."""
    N, C = nrm.shape[:2]
    nrm_m = nrm.reshape(N, 3 * C).to(Gc.dtype)
    prod = (nrm_m[..., None] * Gc).float().reshape(N, C, 3, NA)
    return (prod[:, :, 0] + prod[:, :, 1] + prod[:, :, 2]).to(Gc.dtype)


def _q_contact_merged(kpen_g, nrm_g, kpen_all, Jn_a_all):
    """Generalized contact-spring force (N,75): the linear block Σ_c f_c·n_c
    over the ground rows only (the pair rows' linear columns are zero), the
    angular block through every normal row."""
    return torch.cat([torch.einsum("nc,nci->ni", kpen_g, nrm_g),
                      torch.einsum("nc,ncd->nd", kpen_all, Jn_a_all.float())],
                     dim=-1)


def _merged_rows(model: Model, G, W, ground, selfrows=None,
                 table: str = "capsule", weight_fn=None):
    """Stack the LHS row families into R (N, M, 75) with weights wv (N, M):
    body rows [e_i | G] (w = m_k), inertia rows [0 | W] (w = 1), point rows
    [e_i | Gc] (w = wt), normal rows [n | Jn] (w = wn − wt), then with
    `selfrows` = (Gcs, Jn_sa, wn_s, wt_s) the pair rows [0 | Gcs] (w = wt_s)
    and [0 | Jn_sa] (w = wn_s − wt_s). Weighted sums of outer products of
    R's rows give the whole LHS.

    With `weight_fn` (torch.sqrt for the single-operand √w Gram) each family
    is scaled by weight_fn(w) in the row dtype before the concat and wv is
    ones; without it wv is the weights' concat, cast to the row dtype after
    it, as in the JAX engine."""
    s = _statics(G.device)
    p = model.params
    Gc, Jn_a, nrm, wn, wt = ground
    rdt = G.dtype
    N = G.shape[0]
    isel = s["isel"].to(rdt).expand(N, MROWS, 3)
    iselc = _table_statics(table, G.device)["iselc"].to(rdt)
    iselc = iselc.expand(N, *iselc.shape)
    mass_m = torch.repeat_interleave(p.mass, 3, dim=-1)  # (N,72)

    def zeros(rows):
        return torch.zeros(rows.shape[:2] + (3,), dtype=rdt, device=G.device)

    rows = [torch.cat([isel, G], -1),
            torch.cat([zeros(W), W], -1),
            torch.cat([iselc, Gc], -1),
            torch.cat([nrm.to(rdt), Jn_a], -1)]
    wgt = [mass_m, None, torch.repeat_interleave(wt, 3, dim=-1), wn - wt]
    if selfrows is not None:
        Gcs, Jn_sa, wn_s, wt_s = selfrows
        rows += [torch.cat([zeros(Gcs), Gcs], -1),
                 torch.cat([zeros(Jn_sa), Jn_sa], -1)]
        wgt += [torch.repeat_interleave(wt_s, 3, dim=-1), wn_s - wt_s]
    if weight_fn is not None:
        rows = [r if w is None else r * weight_fn(w.to(rdt))[..., None]
                for r, w in zip(rows, wgt)]
        R = torch.cat(rows, dim=1)
        return R, torch.ones(R.shape[:2], dtype=rdt, device=R.device)
    wv = torch.cat([torch.ones_like(mass_m) if w is None else w
                    for w in wgt], dim=1).to(rdt)
    return torch.cat(rows, dim=1), wv


def _assemble_lhs_rhs(model: Model, G, W, q, v_b, w_b, f_lin, dt, Q_rest,
                      diag, ground, selfrows=None, table: str = "capsule",
                      batch_major: bool = False, gram: bool = False,
                      sqrt_gram: bool = True):
    """The LHS and RHS of one substep, env-last or batch-major."""
    return (_assemble_lhs_merged(model, G, W, diag, ground, selfrows, table,
                                 batch_major=batch_major, gram=gram,
                                 sqrt_gram=sqrt_gram),
            _assemble_rhs_merged(model, G, W, q, v_b, w_b, f_lin, dt, Q_rest,
                                 batch_major=batch_major))


def _assemble_lhs_merged(model: Model, G, W, diag, ground, selfrows=None,
                         table: str = "capsule", batch_major: bool = False,
                         gram: bool = False, sqrt_gram: bool = True):
    """A = Rᵀ(w∘R) + diag, emitted env-last (75, 75, N) or batch-major
    (N, 75, 75), in one of the JAX engine's three forms, in its order:
      - √w (`sqrt_gram and not gram`): S = √w∘R on both sides, SᵀS;
      - `gram`: the gram_diag kernel, batch-major; env-last it emits the
        relayout's 80-row staging shape and to_env_last crops it to 75;
      - two-operand: (w∘R)ᵀR.
    The products cast their operands to float32 BEFORE the batched matmul
    (full float32, TF32 off inside `step`): the JAX engine asks its einsum
    for float32 output from bf16 rows, while a bf16 matmul here would round
    the sums to bf16. w∘R is formed in float32 (exact for bf16 rows), as
    the JAX step's two-operand einsum forms it under jit and as gram_diag
    does, so those two forms differ only in the order of the sums."""
    if sqrt_gram and not gram:
        S, _ = _merged_rows(model, G, W, ground, selfrows, table,
                            weight_fn=torch.sqrt)
        S = S.float()
        return _plus_diag(torch.bmm(S.transpose(1, 2), S), diag, batch_major)
    R, wv = _merged_rows(model, G, W, ground, selfrows, table)
    if gram:
        if batch_major:
            return gram_diag(R, wv, diag)
        staged = NU + (-NU) % 16
        return to_env_last(gram_diag(R, wv, diag, out_rows=staged),
                           out_rows=NU)
    Rf = R.float()
    A = torch.bmm((wv.float()[..., None] * Rf).transpose(1, 2), Rf)
    return _plus_diag(A, diag, batch_major)


def _plus_diag(A, diag, batch_major: bool):
    """A (N, 75, 75) + diag(diag), batch-major or moved env-last."""
    eye = _statics(A.device)["eye"]
    if batch_major:
        return A + eye[None] * diag[:, :, None]
    At = A.permute(1, 2, 0).contiguous()
    return At + eye[:, :, None] * diag.T[:, None, :]


def _sqrt_gram_ok(cfg: EngineConfig) -> bool:
    """Guard of the single-operand √w Gram, as in the JAX engine: every
    merged-row weight is ≥ 0 iff dt·k_n + d_n ≥ max_friction_damping (wn −
    wt = gate·dt·(dt·k_n + d_n − d_t), d_t ≤ max_friction_damping). STRICT
    inequality, as there: at equality the normal rows' weight can be
    exactly 0. When it fails the step takes the two-operand form."""
    return (cfg.sqrt_gram
            and cfg.substep_dt * cfg.contact_stiffness + cfg.contact_damping
            > cfg.max_friction_damping)


def _shift(A, batch_major: bool):
    """A + 1e-8·I, in either layout."""
    eye = _statics(A.device)["eye"]
    return A + 1e-8 * (eye[None] if batch_major else eye[:, :, None])


def _assemble_rhs_merged(model: Model, G, W, q, v_b, w_b, f_lin, dt,
                         Q_rest, batch_major: bool = False):
    """rhs = M·u + dt·Q as matvecs, env-last (75, N) or batch-major (N, 75):
    Jv·u is the body velocity cache and W·u = √D·Rᵀ·w_b, so each substep
    reads G and W once."""
    p = model.params
    N = G.shape[0]
    rdt = G.dtype
    fvec = p.mass[..., None] * v_b + dt * f_lin           # (N,B,3)
    fm = fvec.reshape(N, MROWS).to(rdt)
    v2 = torch.sqrt(p.inertia) * quat.rotate_inv(q, w_b)
    v2m = v2.reshape(N, MROWS).to(rdt)
    ang = (torch.einsum("nmc,nm->nc", G.float(), fm.float())
           + torch.einsum("nmc,nm->nc", W.float(), v2m.float()))
    Mu = torch.cat([fvec.sum(dim=1), ang], dim=-1)        # (N,75)
    if batch_major:
        return Mu + dt * Q_rest
    return (Mu + dt * Q_rest).T.contiguous()


def _gravity_bias_spring(model, x, q, v_b, w_b, u, target_q, gvec):
    """Generalized-force RHS split as Q = Jvᵀ f_lin + Q_rest: f_lin (N,B,3)
    is the linear gravity − inertial body force, Q_rest (N,75) carries the
    gyroscopic term and the torque-limited Stable-PD spring."""
    s = _statics(x.device)
    p = model.params
    N = x.shape[0]
    parent = s["parent_j"]
    qd = u[:, 6:].reshape(-1, NJ, 3)
    w_root = u[:, 3:6]

    piv_j = x[:, 1:] + quat.rotate(q[:, 1:], model.anchor_c[:, 1:])
    v_piv = (v_b[:, parent]
             + quat.cross(w_b[:, parent], piv_j - x[:, parent]))
    w_sum = torch.einsum("jb,nji->nbi", s["sub"], qd)
    a_vp = (quat.cross(w_root[:, None], v_b - v_b[:, 0:1])
            + quat.cross(w_sum, v_b)
            - torch.einsum("jb,nji->nbi", s["sub"], quat.cross(qd, v_piv)))
    Iw = quat.rotate(q, p.inertia * quat.rotate_inv(q, w_b))
    gyro = quat.cross(w_b, Iw)

    f_lin = p.mass[..., None] * (gvec - a_vp)
    tau_ang = -gyro
    Q = torch.zeros((N, NU), dtype=x.dtype, device=x.device)
    Q[:, 3:] = Q[:, 3:] + tau_ang.reshape(N, MROWS) @ s["jw"]

    qp = q[:, parent]
    q_rel = quat.mul(quat.conjugate(qp), q[:, 1:])
    q_err = quat.mul(q_rel, quat.conjugate(target_q))
    theta = quat.rotate(qp, quat.to_exp_map(q_err))
    spring = -p.kp[..., None] * theta
    nrm = torch.linalg.norm(spring, dim=-1, keepdim=True)
    cap = p.torque_limit[..., None]
    spring = spring * (torch.minimum(nrm, cap) / torch.clamp(nrm, min=1e-9))
    Q[:, 6:] = Q[:, 6:] + spring.reshape(N, -1)
    return f_lin, Q


# ---------------------------------------------------------------------------
# 4-D oracles: the JAX engine's layout (N, ·, 3, 75), which the
# tests hold the merged rows and their assembly against
# ---------------------------------------------------------------------------

def _build_jacobians(model: Model, x, q, pivots_x):
    """Body Jacobians Jv4 (N,B,3,75), inertia rows W4 = √D·RᵀJw (N,B,3,75,
    zero linear columns) and term2 (N,B,3,72), the pivot contraction the
    point Jacobians share: Jv[k, :, a] = −[x_k]× + [p_a]× for every
    ancestor a of k."""
    s = _statics(x.device)
    p = model.params
    N = x.shape[0]
    term1 = torch.einsum("nkj,kjic->nkic", x, s["eps_jw"])
    t2 = torch.einsum("naj,ajic->naic", pivots_x, -s["eps_col"])
    term2 = torch.einsum("naic,ak->nkic", t2, s["subx"])
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(N, B, 3, 3)
    Jv4 = torch.cat([eye, term1 + term2], dim=-1)
    RtJw = torch.einsum("nkji,kjc->nkic", quat.to_matrix(q), s["jw3"])
    W = torch.sqrt(p.inertia)[..., None] * RtJw
    W4 = torch.cat([torch.zeros((N, B, 3, 3), dtype=W.dtype,
                                device=W.device), W], dim=-1)
    return Jv4, W4, term2


def _mass_matrix_from_jac(model: Model, Jv4, W4):
    """M = Jv4ᵀ diag(m) Jv4 + W4ᵀW4 (N, 75, 75)."""
    m = model.params.mass[..., None, None]
    return (torch.einsum("nkic,nkid->ncd", m * Jv4, Jv4)
            + torch.einsum("nkic,nkid->ncd", W4, W4))


def _assemble_lhs(model: Model, Jv4, W4, diag, wn, wt, Jn, Jc):
    """The 4-D LHS, env-last (75, 75, N): Jvᵀm Jv + WᵀW + wt·JcᵀJc +
    (wn − wt)·JnᵀJn + diag."""
    m = model.params.mass[..., None, None]
    At = torch.einsum("nkic,nkid->cdn", m * Jv4, Jv4)
    At = At + torch.einsum("nkic,nkid->cdn", W4, W4)
    At = At + torch.einsum("nkic,nkid->cdn", wt[..., None, None] * Jc, Jc)
    At = At + torch.einsum("nci,ncj->ijn", (wn - wt)[..., None] * Jn, Jn)
    eye = _statics(At.device)["eye"]
    return At + eye[:, :, None] * diag.T[:, None, :]


def _assemble_rhs(model: Model, Jv4, W4, q, v_b, w_b, f_lin, dt, Q_rest):
    """The 4-D right-hand side M·u + dt·Q, env-last (75, N)."""
    p = model.params
    Mu = torch.einsum("nkic,nki->cn", Jv4, p.mass[..., None] * v_b
                      + dt * f_lin)
    v2 = torch.sqrt(p.inertia) * quat.rotate_inv(q, w_b)
    Mu = Mu + torch.einsum("nkic,nki->cn", W4, v2)
    return Mu + dt * Q_rest.T


def _point_jacobians(points, bodies, term2):
    """Velocity Jacobians (N, C, 3, 75) of world points attached to
    `bodies` (index array) from _build_jacobians' term2."""
    N, C = points.shape[:2]
    bodies = torch.as_tensor(bodies, dtype=torch.long, device=points.device)
    eps = _statics(points.device)["eps_jw"][bodies]        # (C,3,3,72)
    term1 = torch.einsum("ncj,cjid->ncid", points, eps)
    eye = torch.eye(3, dtype=points.dtype,
                    device=points.device).expand(N, C, 3, 3)
    return torch.cat([eye, term1 + term2[:, bodies]], dim=-1)


def _self_pair_jacobians(cA, cB, term2):
    """Relative-velocity Jacobian (N,K,3,75) of the self-contact pairs in
    one contraction: the A side's minus the B side's; the root-linear
    columns are exactly zero."""
    s = _table_statics("self", cA.device)
    ang = torch.einsum("ncsj,csjid->ncid", torch.stack([cA, cB], dim=2),
                       s["eps"])
    ang = ang + term2[:, s["body"]] - term2[:, s["body_b"]]
    z = torch.zeros(ang.shape[:3] + (3,), dtype=ang.dtype, device=ang.device)
    return torch.cat([z, ang], dim=-1)


def _self_contact_rows(model: Model, x, q, v_b, w_b, term2,
                       cfg: EngineConfig, speculative: bool):
    """Self-contact rows in the 4-D layout: ((Jc, Jn, nrm, active, d_t,
    pen_f_masked, wn, wt), (cA, cB)), gated as the merged rows are."""
    (cA, cB, nrm, active, d_t, pen_f_m, wn, wt) = _self_contact_gates(
        model, x, q, v_b, w_b, cfg, speculative)
    Jc = _self_pair_jacobians(cA, cB, term2)
    Jn = torch.einsum("nci,ncij->ncj", nrm, Jc)
    return (Jc, Jn, nrm, active, d_t, pen_f_m, wn, wt), (cA, cB)


# ---------------------------------------------------------------------------
# Contacts
# ---------------------------------------------------------------------------

def _contact_points(model: Model, x, q):
    """Capsule end-sphere centers of the contact table (N, C, 3)."""
    s = _statics(x.device)
    a = model.params.capsule_axis * model.params.capsule_half[..., None]
    offs = torch.stack([-a, a], dim=2)                    # (N,B,2,3)
    pts = x[:, :, None] + quat.rotate(q[:, :, None], offs)
    return pts[:, _table_statics("capsule", x.device)["body"],
               s["contact_end"]]


def _point_velocities(x, v_b, w_b, pts, bodies):
    """v_pt = v_b + w_b × (pt − x_b) for points attached to `bodies`."""
    return v_b[:, bodies] + quat.cross(w_b[:, bodies], pts - x[:, bodies])


def _capsule_segments(model: Model, x, q, bodies):
    """World-space segment endpoints of the capsules of `bodies`."""
    p = model.params
    a = p.capsule_axis[:, bodies] * p.capsule_half[:, bodies, None]
    off = quat.rotate(q[:, bodies], a)
    xb = x[:, bodies]
    return xb - off, xb + off


def _self_contact_geometry(model: Model, x, q):
    """Closest points of the _SELF_PAIR capsule segments (branchless
    Ericson segment-segment), the normal n = (cA − cB)/‖·‖ and the
    penetration rA + rB − dist: (cA, cB, nrm (N,K,3), pen (N,K))."""
    s = _table_statics("self", x.device)
    pA0, pA1 = _capsule_segments(model, x, q, s["body"])
    pB0, pB1 = _capsule_segments(model, x, q, s["body_b"])
    d1 = pA1 - pA0
    d2 = pB1 - pB0
    r = pA0 - pB0
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d1 * r, -1)
    f = torch.sum(d2 * r, -1)
    denom = a * e - b * b
    ok = denom > 1e-9
    sv = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, 1.0), 0.0)
    sv = torch.clamp(sv, 0.0, 1.0)
    t = torch.clamp((b * sv + f) / torch.clamp(e, min=1e-9), 0.0, 1.0)
    sv = torch.clamp((b * t - c) / torch.clamp(a, min=1e-9), 0.0, 1.0)
    cA = pA0 + d1 * sv[..., None]
    cB = pB0 + d2 * t[..., None]
    delta = cA - cB
    dist = torch.linalg.norm(delta, dim=-1)
    nrm = delta / torch.clamp(dist, min=1e-6)[..., None]
    rad = model.params.capsule_radius
    return cA, cB, nrm, rad[:, s["body"]] + rad[:, s["body_b"]] - dist


def _self_contact_gates(model: Model, x, q, v_b, w_b, cfg: EngineConfig,
                        speculative: bool):
    """The self pairs' geometry and implicit-row weights: (cA, cB, nrm,
    active, d_t, pen_f_masked, wn, wt). `speculative` (the TGS step, whose
    factor serves the whole control step) gates the LHS rows of pairs that
    close within the step at their relative normal velocity; the implicit
    substep gates by the true penetration."""
    s = _table_statics("self", x.device)
    dt = cfg.substep_dt
    cA, cB, nrm, pen = _self_contact_geometry(model, x, q)
    active = (pen > 0.0).to(x.dtype)
    vpt = (_point_velocities(x, v_b, w_b, cA, s["body"])
           - _point_velocities(x, v_b, w_b, cB, s["body_b"]))
    vn = torch.sum(vpt * nrm, dim=-1)
    vt = vpt - nrm * vn[..., None]
    vt_mag = torch.linalg.norm(vt, dim=-1)
    k_n = cfg.contact_stiffness
    d_n = cfg.contact_damping
    pen_f = torch.clamp(pen, max=cfg.max_depenetration)
    mu = torch.where(vt_mag < cfg.friction_vel_ref,
                     cfg.static_friction, cfg.dynamic_friction)
    mu = mu * model.params.friction_scale[:, None]
    d_t = mu * (k_n * torch.clamp(pen_f, min=0.0)) / (vt_mag
                                                     + cfg.friction_vel_ref)
    d_t = torch.clamp(d_t, max=cfg.max_friction_damping)
    if speculative:
        pen_pred = pen + (-cfg.control_dt * torch.clamp(vn, max=0.0))
        gate = (pen_pred > 0.0).to(x.dtype)
        d_t_lhs = mu * (k_n * torch.clamp(pen_pred, 0.0,
                                          cfg.max_depenetration)) \
            / (vt_mag + cfg.friction_vel_ref)
        d_t_lhs = torch.clamp(d_t_lhs, max=cfg.max_friction_damping)
        wt = gate * dt * d_t_lhs
    else:
        gate = active
        wt = gate * dt * d_t
    wn = gate * dt * (dt * k_n + d_n)
    return cA, cB, nrm, active, d_t, active * pen_f, wn, wt


def _self_contact_rows_merged(model: Model, x, q, v_b, w_b, t2m,
                              cfg: EngineConfig, speculative: bool):
    """Merged self-contact rows: Gcs (N,3K,72) relative pair Jacobian rows,
    Jn_sa (N,K,72) their normal projections. Returns ((Gcs, Jn_sa, nrm,
    active, d_t, pen_f_masked, wn, wt), (cA, cB))."""
    (cA, cB, nrm, active, d_t, pen_f_m, wn, wt) = _self_contact_gates(
        model, x, q, v_b, w_b, cfg, speculative)
    Gcs = _point_rows_merged(torch.stack([cA, cB], dim=2), "self", t2m)
    Jn_sa = _normal_rows_merged(nrm, Gcs)
    return (Gcs, Jn_sa, nrm, active, d_t, pen_f_m, wn, wt), (cA, cB)


def _ground_table(cfg: EngineConfig) -> str:
    return "mesh" if cfg.mesh_contacts else "capsule"


def _ground_geometry(model: Model, x, q, cfg: EngineConfig):
    """The ground sample set: (points (N,C,3), radius (N,C), point → body
    index (C,)): the capsule end-spheres, or with `mesh_contacts` the mesh
    colliders of the same bodies (MESH_K spheres each, BodyParams.
    mesh_points in the COM frame)."""
    table = _table_statics(_ground_table(cfg), x.device)
    if cfg.mesh_contacts:
        u = _statics(x.device)["mesh_body_u"]
        mp = model.params.mesh_points[:, u]               # (N,14,K,3)
        mr = model.params.mesh_point_radius[:, u]
        N = x.shape[0]
        pts = x[:, u, None] + quat.rotate(q[:, u, None], mp)
        return (pts.reshape(N, NC_MESH, 3), mr.reshape(N, NC_MESH),
                table["body"])
    return (_contact_points(model, x, q),
            model.params.capsule_radius[:, table["body"]], table["body"])


def _terrain_contact_lookup(terrain: Heightfield, x, pts, cfg: EngineConfig):
    """Height and normal under the contact points: through each env's
    corner_patch window around its root when `terrain_patch` is set (and
    the terrain has a corner texture), else the global lookup."""
    if cfg.terrain_patch and terrain.corner_tex is not None:
        patch, xb, yb = corner_patch(terrain, x[:, 0, :2], cfg.terrain_patch)
        return height_and_normal_at_patch(terrain, patch, xb, yb,
                                          pts[..., :2])
    return height_and_normal_at(terrain, pts[..., :2])


def _readback_onehot(cfg: EngineConfig, device):
    """Row → body map of the force readback: the ground table's rows, then
    the signed pair rows with `self_contact`."""
    ground = _table_statics(_ground_table(cfg), device)["onehot"]
    if cfg.self_contact:
        return torch.cat([ground, _table_statics("self", device)["onehot"]])
    return ground


def _contact_and_jacobians(model: Model, terrain: Heightfield,
                           st: PhysicsState, cfg: EngineConfig,
                           speculative: bool = True):
    """Step-start geometry in the row-merged layout. Returns
    (G, W, ground, Jn_a_all, nrm, active, d_t, pen_f_m, diag, h, radius,
    pts, ground_body, selfrows, self_pts, table) with ground = (Gc, Jn_a,
    nrm_g, wn, wt) and selfrows = (Gcs, Jn_sa, wn_s, wt_s) or None; Jn_a_all,
    nrm, active, d_t and pen_f_m are the ground rows followed by the pair
    rows (the readback's order), h, radius and pts the ground rows'. The
    TGS step, which reuses the LHS over the control step, wants
    `speculative` LHS rows (see below); the implicit substep re-assembles
    every substep and gates its rows by the true penetration."""
    s = _statics(st.u.device)
    p = model.params
    N = st.num_envs
    dt = cfg.substep_dt
    x, q = st.body_x, st.body_q

    piv_j = x[:, 1:] + quat.rotate(q[:, 1:], model.anchor_c[:, 1:])
    pivots_x = torch.cat([x[:, 0:1], piv_j], dim=1)
    rdt = torch.bfloat16 if cfg.rows_bf16 else torch.float32
    G, W, t2m = _build_rows_merged(model, x, q, pivots_x, rdt)

    diag_joint = dt * p.kd + dt * dt * p.kp
    f32 = dict(dtype=x.dtype, device=x.device)
    diag = torch.cat([
        torch.full((N, 3), dt * cfg.linear_damping, **f32),
        torch.full((N, 3), dt * cfg.angular_damping, **f32),
        torch.repeat_interleave(diag_joint, 3, dim=-1),
    ], dim=-1)

    table = _ground_table(cfg)
    pts, radius, body = _ground_geometry(model, x, q, cfg)
    h, nrm = _terrain_contact_lookup(terrain, x, pts, cfg)
    pen = (h + radius - pts[..., 2]) * nrm[..., 2]
    active = (pen > 0.0).to(x.dtype)
    Gc = _point_rows_merged(pts, table, t2m)
    vpt = _point_velocities(x, st.body_v, st.body_w, pts, body)
    vn = torch.sum(vpt * nrm, dim=-1)
    vt = vpt - nrm * vn[..., None]
    vt_mag = torch.linalg.norm(vt, dim=-1)

    k_n = cfg.contact_stiffness
    d_n = cfg.contact_damping
    pen_f = torch.clamp(pen, max=cfg.max_depenetration)
    mu = torch.where(vt_mag < cfg.friction_vel_ref,
                     cfg.static_friction, cfg.dynamic_friction)
    mu = mu * p.friction_scale[:, None]
    d_t = mu * (k_n * pen_f) / (vt_mag + cfg.friction_vel_ref)
    d_t = torch.clamp(d_t, max=cfg.max_friction_damping)

    Jn_a = _normal_rows_merged(nrm, Gc)
    if speculative:
        # a contact that can engage within the control step gets its
        # implicit rows now, so the factor reused across substeps solves a
        # mid-step touchdown implicitly; RHS forces stay gated by the true
        # penetration
        reach = (-cfg.control_dt * torch.clamp(vn, max=0.0)
                 + 0.5 * abs(cfg.gravity) * cfg.control_dt ** 2)
        pen_pred = pen + reach
        active_lhs = (pen_pred > 0.0).to(x.dtype)
        d_t_lhs = mu * (k_n * torch.clamp(pen_pred, 0.0,
                                          cfg.max_depenetration)) \
            / (vt_mag + cfg.friction_vel_ref)
        d_t_lhs = torch.clamp(d_t_lhs, max=cfg.max_friction_damping)
    else:
        active_lhs, d_t_lhs = active, d_t
    wn = active_lhs * dt * (dt * k_n + d_n)
    wt = active_lhs * dt * d_t_lhs
    ground = (Gc, Jn_a, nrm, wn, wt)
    pen_f_m = active * pen_f
    selfrows = self_pts = None
    if cfg.self_contact:
        (Gcs, Jn_sa, nrm_s, act_s, d_t_s, pen_f_s, wn_s, wt_s), self_pts = \
            _self_contact_rows_merged(model, x, q, st.body_v, st.body_w,
                                      t2m, cfg, speculative)
        selfrows = (Gcs, Jn_sa, wn_s, wt_s)
        Jn_a = torch.cat([Jn_a, Jn_sa], dim=1)
        nrm = torch.cat([nrm, nrm_s], dim=1)
        active = torch.cat([active, act_s], dim=1)
        d_t = torch.cat([d_t, d_t_s], dim=1)
        pen_f_m = torch.cat([pen_f_m, pen_f_s], dim=1)
    return (G, W, ground, Jn_a, nrm, active, d_t, pen_f_m, diag, h, radius,
            pts, body, selfrows, self_pts, table)


def _readback_contact(st_new: PhysicsState, pts, body, self_pts, nrm,
                      active, d_t, k_n, pen_f, dt, d_n, onehot):
    """Per-body contact force from the post-integration velocity cache,
    normal force clamped unilateral (as the reference reports it); the
    pair rows (after the ground rows, `self_pts` = (cA, cB) or None) take
    the relative velocity and map signed, +F on A and −F on B."""
    x, v_b, w_b = st_new.body_x, st_new.body_v, st_new.body_w
    vpt_new = _point_velocities(x, v_b, w_b, pts, body)
    if self_pts is not None:
        cA, cB = self_pts
        s = _table_statics("self", x.device)
        vpt_s = (_point_velocities(x, v_b, w_b, cA, s["body"])
                 - _point_velocities(x, v_b, w_b, cB, s["body_b"]))
        vpt_new = torch.cat([vpt_new, vpt_s], dim=1)
    vn_new = torch.sum(vpt_new * nrm, dim=-1)
    f_n = active * (k_n * pen_f - (dt * k_n + d_n) * vn_new)
    f_n = torch.clamp(f_n, min=0.0)
    vt_new = vpt_new - nrm * vn_new[..., None]
    f_t = -d_t[..., None] * vt_new * active[..., None]
    f_c = f_n[..., None] * nrm + f_t                      # (N,C,3)
    return torch.einsum("cb,nci->nbi", onehot, f_c)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _velocity_clamp(u_new, cfg: EngineConfig):
    """Norm clamps on root linear, root angular and joint velocities."""
    N = u_new.shape[0]

    def _norm_clamp(v, cap):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v * (torch.clamp(n, max=cap) / torch.clamp(n, min=1e-9))

    return torch.cat([
        _norm_clamp(u_new[:, 0:3], cfg.max_linear_velocity),
        _norm_clamp(u_new[:, 3:6], cfg.max_angular_velocity),
        _norm_clamp(u_new[:, 6:].reshape(N, NJ, 3),
                    cfg.max_angular_velocity).reshape(N, -1),
    ], dim=-1)


def _integrate_pose(model: Model, state: PhysicsState, u_new, dt, tree):
    """Integrate root/joint poses, clamp joint limits (position clamp +
    velocity projection) and refresh the body cache."""
    p = model.params
    N = u_new.shape[0]
    q = state.body_q
    v_root = u_new[:, 0:3]
    w_root = u_new[:, 3:6]
    qd = u_new[:, 6:].reshape(N, NJ, 3)

    root_pos = state.root_pos + dt * v_root
    root_rot = quat.normalize(
        quat.mul(quat.exp_map_to_quat(w_root * dt), state.root_rot))
    qp = q[:, _statics(q.device)["parent_j"]]
    dq_local = quat.exp_map_to_quat(quat.rotate_inv(qp, qd) * dt)
    joint_rot = quat.normalize(quat.mul(dq_local, state.joint_rot))

    th = quat.to_exp_map(joint_rot)
    lim = p.joint_limit
    th_cl = torch.maximum(torch.minimum(th, lim), -lim)
    hit = torch.abs(th - th_cl) > 1e-7
    joint_rot = torch.where(hit.any(-1, keepdim=True),
                            quat.exp_map_to_quat(th_cl), joint_rot)
    qd_local = quat.rotate_inv(qp, qd)
    qd_local = torch.where(hit, 0.0, qd_local)
    qd = quat.rotate(qp, qd_local)
    u_new = torch.cat([u_new[:, :6], qd.reshape(N, -1)], dim=-1)

    new_state = state.replace(root_pos=root_pos, root_rot=root_rot,
                              joint_rot=joint_rot, u=u_new)
    return refresh_cache(model, new_state, tree)


def step(model: Model, terrain: Heightfield, state: PhysicsState,
         pd_target: torch.Tensor, cfg: EngineConfig = EngineConfig(),
         tree=None) -> PhysicsState:
    """Advance one control step (cfg.n_substeps substeps): the TGS step
    when `tgs_step` and n_substeps > 1, else n_substeps fully re-assembled
    implicit substeps, as the JAX engine's `_step` dispatches."""
    if tree is None:
        tree = default_tree()
    with annotate("physics.step"):
        target_q = quat.exp_map_to_quat(pd_target)
        with _full_f32_matmul():
            if cfg.tgs_step and cfg.n_substeps > 1:
                return _tgs_step(model, terrain, state, target_q, cfg, tree)
            for _ in range(cfg.n_substeps):
                state = _implicit_substep(model, terrain, state, target_q,
                                          cfg, tree)
            return state


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls on the card in full float32, not TF32, for the
    duration: the Jacobian and Gram products feed the factorization of a
    stiff system. This is `torch.backends.cuda.matmul.allow_tf32 = False`
    under its current name; the caller's setting is restored on exit, so
    the step changes no other matmul of the process."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def _tgs_step(model: Model, terrain, state: PhysicsState, target_q,
              cfg: EngineConfig, tree) -> PhysicsState:
    """One control step reusing the substep-1 Jacobians and factor.

    Substep 1 builds everything fresh and factors the LHS once; later
    substeps refresh penetrations (the ground rows' against the substep-1
    heights, the pairs' from fresh closest points), gravity/bias/spring
    forces and the PD error but reuse the projections (Jacobians, normals,
    friction coefficients) and the factor — the per-step staleness PhysX
    TGS accepts. With `batch_major_solver` the system is assembled
    batch-major, relaid env-last for the factor, and the substeps'
    right-hand sides and solutions stay batch-major."""
    dt = cfg.substep_dt
    gvec = torch.tensor([0.0, 0.0, cfg.gravity], device=state.u.device)
    k_n = cfg.contact_stiffness
    d_n = cfg.contact_damping
    arrow = (_ARROW_CHUNKS, _ARROW_LIMBS, _ARROW_S)
    bm = _batch_major(cfg)

    st = state
    with annotate("physics.contacts"):
        (G, W, ground, Jn_a_all, nrm, active, d_t, pen_f, diag, h0, radius,
         pts0, body, selfrows, self_pts0, table) = _contact_and_jacobians(
             model, terrain, st, cfg)
    ng = radius.shape[1]          # ground rows (capsule or mesh table)
    with annotate("physics.assemble"):
        f_lin, Q_rest = _gravity_bias_spring(model, st.body_x, st.body_q,
                                             st.body_v, st.body_w, st.u,
                                             target_q, gvec)
        Q_rest = Q_rest + _q_contact_merged(k_n * pen_f[:, :ng],
                                            nrm[:, :ng], k_n * pen_f,
                                            Jn_a_all)
        At, rhs_t = _assemble_lhs_rhs(model, G, W, st.body_q, st.body_v,
                                      st.body_w, f_lin, dt, Q_rest, diag,
                                      ground, selfrows, table,
                                      batch_major=bm, gram=cfg.gram_kernel,
                                      sqrt_gram=_sqrt_gram_ok(cfg))
        At = _shift(At, bm)
    if not _arrow_exact(cfg):
        # the dense solve of the whole LHS, refactored each substep (the
        # dense kernel fuses factor and solve): the same A, the same L
        def resolve(rhs):
            return cholesky_solve_soa_t(At, rhs).T
    elif bm:
        with annotate("physics.factor"):
            L = cholesky_factor_blocked(At, *arrow)

        def resolve(rhs):
            return cholesky_resolve_blocked(L, rhs, *arrow)
    else:
        with annotate("physics.factor"):
            L = cholesky_factor_blocked_t(At, *arrow)

        def resolve(rhs):
            return cholesky_resolve_blocked_t(L, rhs, *arrow).T

    onehot = _readback_onehot(cfg, st.u.device)
    with annotate("physics.solve"):
        u_new = _velocity_clamp(resolve(rhs_t), cfg)
    with annotate("physics.integrate"):
        st = _integrate_pose(model, st, u_new, dt, tree)
        st = st.replace(contact_force=_readback_contact(
            st, pts0, body, self_pts0, nrm, active, d_t, k_n, pen_f, dt, d_n,
            onehot))

    for _ in range(cfg.n_substeps - 1):
        with annotate("physics.contacts"):
            pts, _, _ = _ground_geometry(model, st.body_x, st.body_q, cfg)
            pen = (h0 + radius - pts[..., 2]) * nrm[:, :ng, 2]
            self_pts = None
            if cfg.self_contact:
                cA, cB, _, pen_s = _self_contact_geometry(model, st.body_x,
                                                          st.body_q)
                pen = torch.cat([pen, pen_s], dim=1)
                self_pts = (cA, cB)
            act = (pen > 0.0).to(pen.dtype)
            pf = act * torch.clamp(pen, max=cfg.max_depenetration)
        with annotate("physics.assemble"):
            f_l, Q_r = _gravity_bias_spring(model, st.body_x, st.body_q,
                                            st.body_v, st.body_w, st.u,
                                            target_q, gvec)
            Q_r = Q_r + _q_contact_merged(k_n * pf[:, :ng], nrm[:, :ng],
                                          k_n * pf, Jn_a_all)
            rhs = _assemble_rhs_merged(model, G, W, st.body_q, st.body_v,
                                       st.body_w, f_l, dt, Q_r,
                                       batch_major=bm)
        with annotate("physics.solve"):
            u2 = _velocity_clamp(resolve(rhs), cfg)
        with annotate("physics.integrate"):
            st2 = _integrate_pose(model, st, u2, dt, tree)
            st = st2.replace(contact_force=_readback_contact(
                st2, pts, body, self_pts, nrm, act, d_t, k_n, pf, dt, d_n,
                onehot))
    return st


def _arrow_exact(cfg: EngineConfig) -> bool:
    """Whether the block-arrow kernels solve this configuration's LHS whole:
    always, unless self-contact pairs add entries outside their pattern
    (SELF_ROWS_FIT_ARROW). Then both steps solve with the dense Cholesky
    kernel, env-last, which is what the JAX engine computes on the CPU (its
    Pallas path would drop those entries)."""
    return not cfg.self_contact or SELF_ROWS_FIT_ARROW


def _batch_major(cfg: EngineConfig) -> bool:
    """The JAX engine's rule `batch_major_solver and (blocked_solver or not
    use_pallas)` on its Pallas side, which the port always takes: the
    batch-major layout pairs with the block-arrow kernels only (so not with
    the dense solve of `_arrow_exact`). Likewise the JAX rule `gram_kernel
    and use_pallas` is `cfg.gram_kernel` here: the Gram kernel runs whenever
    it is asked for (its plain version on a CPU tensor)."""
    return (cfg.batch_major_solver and cfg.blocked_solver
            and _arrow_exact(cfg))


def _implicit_substep(model: Model, terrain, state: PhysicsState, target_q,
                      cfg: EngineConfig, tree) -> PhysicsState:
    """One fully re-assembled implicit substep: fresh Jacobians, contact set
    and LHS rows gated by the true penetration (no speculation, the pair
    rows' neither: nothing is reused), solved with the fused block-arrow
    kernel — env-last, or batch-major through the relayout — or the dense
    Cholesky kernel."""
    dt = cfg.substep_dt
    gvec = torch.tensor([0.0, 0.0, cfg.gravity], device=state.u.device)
    k_n = cfg.contact_stiffness
    d_n = cfg.contact_damping
    arrow = (_ARROW_CHUNKS, _ARROW_LIMBS, _ARROW_S)
    bm = _batch_major(cfg)

    st = state
    with annotate("physics.contacts"):
        (G, W, ground, Jn_a_all, nrm, active, d_t, pen_f, diag, _, radius,
         pts, body, selfrows, self_pts, table) = _contact_and_jacobians(
             model, terrain, st, cfg, speculative=False)
    ng = radius.shape[1]
    with annotate("physics.assemble"):
        f_lin, Q_rest = _gravity_bias_spring(model, st.body_x, st.body_q,
                                             st.body_v, st.body_w, st.u,
                                             target_q, gvec)
        Q_rest = Q_rest + _q_contact_merged(k_n * pen_f[:, :ng],
                                            nrm[:, :ng], k_n * pen_f,
                                            Jn_a_all)
        At, rhs_t = _assemble_lhs_rhs(model, G, W, st.body_q, st.body_v,
                                      st.body_w, f_lin, dt, Q_rest, diag,
                                      ground, selfrows, table,
                                      batch_major=bm, gram=cfg.gram_kernel,
                                      sqrt_gram=_sqrt_gram_ok(cfg))
        At = _shift(At, bm)
    with annotate("physics.solve"):
        if bm:
            u_new = cholesky_solve_blocked(At, rhs_t, *arrow)
        elif cfg.blocked_solver and _arrow_exact(cfg):
            u_new = cholesky_solve_blocked_t(At, rhs_t, *arrow).T
        else:
            u_new = cholesky_solve_soa_t(At, rhs_t).T
        u_new = _velocity_clamp(u_new, cfg)
    with annotate("physics.integrate"):
        st2 = _integrate_pose(model, st, u_new, dt, tree)
        return st2.replace(contact_force=_readback_contact(
            st2, pts, body, self_pts, nrm, active, d_t, k_n, pen_f, dt, d_n,
            _readback_onehot(cfg, st.u.device)))
