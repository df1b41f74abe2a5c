"""Motion library: reference-motion storage, sampling and blended queries.

Port of emloco_tpu/kinematics/motion_lib.py: motions are flattened into
tensors indexed by `length_starts`, queried by (motion_id, time) with frame
blending and slerp. `synthetic_walk_motions` builds the procedural gaits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import device as _device
from ..ops import quat
from ..parallel.mesh import draw_rows
from ..struct import TensorStruct
from . import body_model as bm
from .skeleton import forward_kinematics

B = bm.NUM_BODIES


@dataclasses.dataclass(frozen=True)
class MotionLib(TensorStruct):
    """Flattened motion frames. F = total frames over all motions."""

    local_rot: torch.Tensor      # (F, 24, 4) local joint rotations
    root_pos: torch.Tensor       # (F, 3) pelvis pivot position
    root_vel: torch.Tensor       # (F, 3)
    root_ang_vel: torch.Tensor   # (F, 3)
    dof_vel: torch.Tensor        # (F, 23, 3) joint ang vel (parent frame)
    key_pos: torch.Tensor        # (F, K, 3) key body world positions
    betas: torch.Tensor          # (M, 16)
    fps: torch.Tensor            # (M,)
    length_starts: torch.Tensor  # (M,) start frame of each motion
    num_frames: torch.Tensor     # (M,)
    durations: torch.Tensor      # (M,) seconds
    weights: torch.Tensor        # (M,) sampling weights (normalized)

    @property
    def num_motions(self):
        return self.length_starts.shape[0]


def _finite_diff_velocities(local_rot, root_pos, fps):
    dt = 1.0 / fps
    root_vel = torch.gradient(root_pos, dim=0)[0] / dt
    q = local_rot[:, 0]
    q0 = torch.cat([q[:1], q[:-1]], dim=0)
    root_ang_vel = quat.angular_velocity(q0, q, dt)
    lr = local_rot[:, 1:]
    lr0 = torch.cat([lr[:1], lr[:-1]], dim=0)
    dq = quat.mul(lr, quat.conjugate(lr0))
    dof_vel = quat.to_exp_map(dq) / dt
    return root_vel, root_ang_vel, dof_vel


def _build(tree, motions, betas_list, fps_list, dev, weights=None):
    """motions: list of (local_rot (F,24,4) np, root_pos (F,3) np)."""
    key_ids = torch.as_tensor([tree.index(n) for n in bm.KEY_BODIES],
                              device=dev)
    cols = {k: [] for k in ("lr", "rp", "rv", "rav", "dv", "kp")}
    starts, nframes, durs = [], [], []
    off = 0
    for (lr, rp), fps in zip(motions, fps_list):
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        rp = torch.as_tensor(rp, dtype=torch.float32, device=dev)
        rv, rav, dv = _finite_diff_velocities(lr, rp, fps)
        _, gpos = forward_kinematics(tree, lr, rp)
        for k, v in zip(cols, (lr, rp, rv, rav, dv, gpos[:, key_ids])):
            cols[k].append(v)
        starts.append(off)
        F = lr.shape[0]
        nframes.append(F)
        durs.append((F - 1) / fps)
        off += F
    M = len(motions)
    w = np.ones(M) if weights is None else np.asarray(weights, np.float64)
    w = w / w.sum()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return MotionLib(
        local_rot=torch.cat(cols["lr"]), root_pos=torch.cat(cols["rp"]),
        root_vel=torch.cat(cols["rv"]), root_ang_vel=torch.cat(cols["rav"]),
        dof_vel=torch.cat(cols["dv"]), key_pos=torch.cat(cols["kp"]),
        betas=torch.as_tensor(np.stack(betas_list), **f32),
        fps=torch.as_tensor(fps_list, **f32),
        length_starts=torch.as_tensor(starts, **i32),
        num_frames=torch.as_tensor(nframes, **i32),
        durations=torch.as_tensor(durs, **f32),
        weights=torch.as_tensor(w, **f32),
    )


def synthetic_walk_motions(
    tree=None,
    speeds: Sequence[float] = (0.8, 1.0, 1.25, 1.5, 2.0, 2.5),
    fps: float = 30.0,
    duration: float = 4.0,
    betas: np.ndarray | None = None,
    height: float = 0.92,
    device=None,
) -> MotionLib:
    """Procedural walking gaits (sagittal sinusoid gait model), the same
    frames as the JAX package's generator."""
    dev = _device.resolve(device)
    if tree is None:
        tree = bm.canonical_skeleton()
    F = int(duration * fps) + 1
    t = np.arange(F) / fps
    motions, betas_list, fps_list = [], [], []
    for v in speeds:
        step_len = np.clip(0.35 + 0.25 * v, 0.4, 1.0)
        cadence = v / step_len * np.pi * 2 / 2
        phase = cadence * t
        lr = np.zeros((F, B, 4), np.float32)
        lr[..., 3] = 1.0

        def setj(name, axis, angle):
            em = np.zeros((F, 3), np.float32)
            em[:, axis] = angle
            lr[:, tree.index(name)] = quat.exp_map_to_quat(
                torch.from_numpy(em)).numpy()

        hip_amp = 0.35 + 0.1 * v / 2
        setj("L_Hip", 1, hip_amp * np.sin(phase))
        setj("R_Hip", 1, hip_amp * np.sin(phase + np.pi))

        def knee(ph):
            return 0.25 + 0.45 * np.maximum(0, np.sin(ph - 0.6))

        setj("L_Knee", 1, knee(phase))
        setj("R_Knee", 1, knee(phase + np.pi))
        setj("L_Ankle", 1, -0.15 * np.sin(phase) - 0.05)
        setj("R_Ankle", 1, -0.15 * np.sin(phase + np.pi) - 0.05)
        setj("L_Shoulder", 0, 0.25 * np.sin(phase + np.pi))
        setj("R_Shoulder", 0, -0.25 * np.sin(phase))
        setj("L_Elbow", 1, 0.3)
        setj("R_Elbow", 1, 0.3)
        setj("Torso", 2, 0.06 * np.sin(phase))

        rp = np.zeros((F, 3), np.float32)
        rp[:, 0] = v * t
        rp[:, 2] = height + 0.02 * np.cos(2 * phase)
        motions.append((lr, rp))
        betas_list.append(np.zeros(16, np.float32) if betas is None else betas)
        fps_list.append(fps)
    return _build(tree, motions, betas_list, fps_list, dev)


def load_reference_pkl(path: str, tree=None, max_motions=None,
                       device=None) -> MotionLib:
    """The reference's AMASS-converted motion pickle (a dict of motions,
    each a dict with pose_aa (F, 72) axis-angle, root_trans_offset (F, 3),
    beta (up to 16) and fps), read with pickle (`load_data_pickle`; a
    joblib file raises) and built as the JAX package's loader builds it."""
    from ..utils.checkpoint import load_data_pickle
    dev = _device.resolve(device)
    if tree is None:
        tree = bm.canonical_skeleton()
    data = load_data_pickle(path)
    motions, betas_list, fps_list = [], [], []
    for i, (name, m) in enumerate(data.items()):
        if max_motions is not None and i >= max_motions:
            break
        pose_aa = np.asarray(m["pose_aa"], np.float32).reshape(-1, 24, 3)
        local_rot = quat.exp_map_to_quat(torch.from_numpy(pose_aa)).numpy()
        root_pos = np.asarray(m["root_trans_offset"], np.float32)
        motions.append((local_rot, root_pos))
        beta = np.asarray(m.get("beta", np.zeros(16)), np.float32)[:16]
        betas_list.append(np.pad(beta, (0, 16 - len(beta))))
        fps_list.append(float(m.get("fps", 30.0)))
    return _build(tree, motions, betas_list, fps_list, dev)


def sample_motions(lib: MotionLib, gen: torch.Generator, n: int,
                   weights=None, mesh=None) -> torch.Tensor:
    """Weighted motion sampling with replacement (`mesh`: n is this rank's
    rows of the whole env axis's draw, parallel.mesh.draw_rows)."""
    p = lib.weights if weights is None else weights
    return draw_rows(lambda shape: torch.multinomial(
        p, shape[0], replacement=True, generator=gen), (n,), mesh)


def hard_negative_update(succ_rate, sampled, terminated, temp: float = 0.2):
    """Hard-negative refresh of the motion-sampling weights: each motion
    sampled since the last refresh gets the success rate 1 − terminations /
    samples (the others keep their estimate), and the new weights are
    exp(−rate/temp), normalized, so that the motions the policy fails on
    are drawn more often. Returns (weights, success rates, zeroed sample
    counts, zeroed termination counts)."""
    seen = sampled > 0
    new_rate = torch.where(
        seen, 1.0 - terminated / torch.clamp(sampled, min=1.0), succ_rate)
    w = torch.exp(-new_rate / temp)
    return (w / w.sum(), new_rate, torch.zeros_like(sampled),
            torch.zeros_like(terminated))


def sample_time(lib: MotionLib, gen: torch.Generator, motion_ids,
                truncate_time=0.0, mesh=None):
    """Uniform phase sampling (`mesh` as in sample_motions)."""
    dur = lib.durations[motion_ids] - truncate_time
    u = draw_rows(torch.rand, motion_ids.shape, mesh, generator=gen,
                  device=dur.device)
    return u * torch.clamp(dur, min=0.0)


def get_motion_state(lib: MotionLib, motion_ids, times):
    """Blended motion state at (motion, time): frame pair + lerp/slerp."""
    fps = lib.fps[motion_ids]
    nf = lib.num_frames[motion_ids]
    phase = times * fps
    f0 = torch.minimum(torch.clamp(torch.floor(phase).to(torch.int32), min=0),
                       nf - 2)
    f1 = f0 + 1
    blend = torch.clamp(phase - f0, 0.0, 1.0)[..., None]

    i0 = (lib.length_starts[motion_ids] + f0).long()
    i1 = (lib.length_starts[motion_ids] + f1).long()

    def lerp(a):
        bl = blend.reshape(blend.shape + (1,) * (a.dim() - 2))
        return (1 - bl) * a[i0] + bl * a[i1]

    lr = quat.slerp(lib.local_rot[i0], lib.local_rot[i1], blend)
    return {
        "root_pos": lerp(lib.root_pos),
        "root_rot": lr[:, 0],
        "local_rot": lr,
        "dof_pos": quat.to_exp_map(lr[:, 1:]),
        "root_vel": lerp(lib.root_vel),
        "root_ang_vel": lerp(lib.root_ang_vel),
        "dof_vel": lerp(lib.dof_vel),
        "key_pos": lerp(lib.key_pos),
        "betas": lib.betas[motion_ids],
    }
