"""Prediction datasets: token building, normalization, synthetic JTA-like
scenes, and trajnet++-style ndjson ingestion (port of
emloco_tpu/prediction/data.py).

  * batch_process_coords (reference social-transmotion/dataset_jta.py:
    27-84): every trajectory shifts so the PRIMARY agent's last observed
    position is the origin; the (B, in_F, N, J, 4) token tensor has the
    layout [traj, 3dbb, 2dbb, 3dpose·24, 2dpose·22].
  * ndjson scene readers (utils/trajnetplusplustools/reader.py:10-143).
  * the synthetic generator stands in for JTA: walking pedestrians whose
    3D poses come from the simulator's gait model and forward kinematics
    (this package's `kinematics`, run on the CPU).
Constants the reference depends on: 2.5 Hz, 9 obs + 12 pred frames, init
pose = 3d joints at the last obs frame, init velocity = (x₈ − x₇)·2.5
(reference train_jta.py:264-273).

Batches are numpy, as the JAX package's are; a trainer moves them to its
device. The generator draws from `np.random.RandomState(seed)` in the JAX
package's order, so a seed gives the same scenes in both packages.
"""
from __future__ import annotations

import json
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..kinematics import body_model as bm
from ..kinematics import motion_lib as ml
from ..kinematics.skeleton import forward_kinematics

FPS = 2.5
OBS_FRAMES = 9
PRED_FRAMES = 12
TOTAL = OBS_FRAMES + PRED_FRAMES
NDJSON_POSE_JOINTS = 22   # JTA exports carry 22 pose joints (x0..x21)
GAIT_SPEEDS = (0.8, 1.2, 1.6, 2.0)


class SceneBatch(NamedTuple):
    """One prediction batch. The LocoVal inputs ride along because the
    reference reads the init pose from the RAW joints (train_jta.py:
    264-266): after normalization the pose tokens are deltas against the
    last observed frame, so the pose cannot be read back out of `obs`."""

    obs: np.ndarray           # (B, in_F, N, J, 4) normalized tokens
    padding_mask: np.ndarray  # (B, N) True = person present
    gt_future: np.ndarray     # (B, out_F, 2) primary agent, normalized
    init_pose: np.ndarray     # (B, 24, 3) RAW primary pose @ last obs frame
    init_vel: np.ndarray      # (B, 2) (x₈−x₇)·2.5


def build_tokens(traj, pose3d=None, box3d=None, box2d=None, pose2d=None,
                 num_3dpose=24, num_2dpose=22):
    """Assemble the (B, F, N, J, 4) token tensor from modality arrays;
    traj (B,F,N,2) is required, missing cues are zeros."""
    B, F, N, _ = traj.shape
    J = 3 + num_3dpose + num_2dpose
    tok = np.zeros((B, F, N, J, 4), np.float32)
    tok[..., 0, :2] = traj
    if box3d is not None:
        tok[..., 1, :4] = box3d
    if box2d is not None:
        tok[..., 2, :4] = box2d
    if pose3d is not None:
        tok[..., 3:3 + num_3dpose, :3] = pose3d
    if pose2d is not None:
        tok[..., 3 + num_3dpose:, :2] = pose2d
    return tok


def normalize_scene(tokens, obs_frames=OBS_FRAMES):
    """The reference's batch_process_coords normalization (dataset_jta.py:
    38-45): every person's trajectory token shifts by the PRIMARY agent's
    last observed position; box tokens (1:3) and pose blocks (3:) each by
    their OWN value at the last observed frame. Returns (tokens, origin)."""
    ref = tokens[:, obs_frames - 1:obs_frames].copy()    # (B,1,N,J,4)
    out = tokens.copy()
    out[..., 0, :2] -= ref[:, :, 0:1, 0, :2]             # primary origin
    out[:, :, :, 1:3] -= ref[:, :, :, 1:3]               # boxes: own last obs
    out[:, :, :, 3:] -= ref[:, :, :, 3:]                 # poses: own last obs
    return out, ref[:, 0, 0, 0, :2]


def extract_locoval_inputs(raw_tokens, num_3dpose: int = 24):
    """The EmLoco loss's inputs (reference train_jta.py:264-273): the RAW
    3d pose of the primary at the last observed frame (zero-padded to 24
    joints; the z-flip happens at consumption) and (x₈ − x₇)·2.5.
    raw_tokens (B,F,N,J,4) → (init_pose (B,24,3), init_vel (B,2))."""
    pose = raw_tokens[:, OBS_FRAMES - 1, 0, 3:3 + num_3dpose, :3]
    if num_3dpose < 24:
        pad = np.zeros(pose.shape[:-2] + (24 - num_3dpose, 3), pose.dtype)
        pose = np.concatenate([pose, pad], axis=-2)
    x8 = raw_tokens[:, OBS_FRAMES - 1, 0, 0, :2]
    x7 = raw_tokens[:, OBS_FRAMES - 2, 0, 0, :2]
    init_vel = (x8 - x7) * FPS
    return pose.astype(np.float32), init_vel.astype(np.float32)


def prepend_origin(pred_traj):
    """(B,Fp,2) → (B,Fp+1,2) with the origin first (train_jta.py:291,301)."""
    return torch.cat([torch.zeros_like(pred_traj[:, :1]), pred_traj], dim=1)


# ---------------------------------------------------------------------------
# Synthetic JTA-like scene generator
# ---------------------------------------------------------------------------

class SyntheticScenes:
    """Procedural multi-pedestrian scenes with kinematically consistent 3D
    poses (gait model + FK on the CPU). Yields batches shaped like the JTA
    pipeline."""

    def __init__(self, num_people=4, seed=0, num_3dpose=24, num_2dpose=22):
        self.num_people = num_people
        self.rng = np.random.RandomState(seed)
        self.tree = bm.canonical_skeleton()
        self.lib = ml.synthetic_walk_motions(
            tree=self.tree, speeds=GAIT_SPEEDS, fps=30.0, duration=10.0,
            device="cpu")
        self.num_3dpose = num_3dpose
        self.num_2dpose = num_2dpose

    def _person(self, T):
        """One pedestrian: a smooth random-walk track and the gait's 3d pose
        at its speed and phase. Returns (xy (T,2), pose (T,24,3),
        heading (T,))."""
        rng = self.rng
        speed = rng.uniform(0.5, 2.0)
        heading0 = rng.uniform(-np.pi, np.pi)
        curv = rng.normal(0, 0.2)
        t = np.arange(T) / FPS
        heading = heading0 + curv * t
        vx = speed * np.cos(heading)
        vy = speed * np.sin(heading)
        xy = np.cumsum(np.stack([vx, vy], -1), 0) / FPS
        xy += rng.uniform(-5, 5, 2)

        mid = int(np.argmin(np.abs(np.array(GAIT_SPEEDS) - speed)))
        t0 = rng.uniform(0, 2.0)
        ms = ml.get_motion_state(
            self.lib, torch.full((T,), mid, dtype=torch.long),
            torch.as_tensor(t0 + t, dtype=torch.float32))
        _, gpos = forward_kinematics(self.tree, ms["local_rot"],
                                     ms["root_pos"])
        gpos = gpos.numpy()
        pose = gpos - gpos[:, 0:1]                       # root-relative
        c, s = np.cos(heading), np.sin(heading)
        R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
        pose_xy = np.einsum("tij,tkj->tki", R, pose[..., :2])
        pose = np.concatenate([pose_xy, pose[..., 2:]], -1)
        return xy.astype(np.float32), pose.astype(np.float32), \
            heading.astype(np.float32)

    def scene(self):
        """One (T, N, …) multi-person scene in the export's modality layout:
        3dbb = (h, w, l, rot_z), 2dbb = (left, top, width, height)
        (reference reader.py:215-219). pose3d is z-DOWN, the raw JTA
        convention, which the consumption flip (train_jta.py:266) undoes."""
        N, T = self.num_people, TOTAL
        traj = np.zeros((T, N, 2), np.float32)
        pose3 = np.zeros((T, N, self.num_3dpose, 3), np.float32)
        box3 = np.zeros((T, N, 4), np.float32)
        box2 = np.zeros((T, N, 4), np.float32)
        pose2 = np.zeros((T, N, self.num_2dpose, 2), np.float32)
        for n in range(N):
            xy, pose, heading = self._person(T)
            traj[:, n] = xy
            pose3[:, n] = pose[:, :self.num_3dpose] * np.array(
                [1.0, 1.0, -1.0], np.float32)
            box3[:, n] = np.stack(
                [np.full(T, 1.8, np.float32), np.full(T, 0.6, np.float32),
                 np.full(T, 0.5, np.float32), heading], -1)
            px = pose[:, :self.num_2dpose, :2] * 50 + 500
            box2[:, n] = np.concatenate(
                [px.min(1), px.max(1) - px.min(1)], -1)
            pose2[:, n] = px
        return dict(traj=traj, pose3d=pose3, box3d=box3, box2d=box2,
                    pose2d=pose2)

    def batch(self, batch_size) -> SceneBatch:
        B, N, T = batch_size, self.num_people, TOTAL
        traj = np.zeros((B, T, N, 2), np.float32)
        pose3 = np.zeros((B, T, N, self.num_3dpose, 3), np.float32)
        box3 = np.zeros((B, T, N, 4), np.float32)
        box2 = np.zeros((B, T, N, 4), np.float32)
        pose2 = np.zeros((B, T, N, self.num_2dpose, 2), np.float32)
        for b in range(B):
            s = self.scene()
            traj[b], pose3[b], box3[b] = s["traj"], s["pose3d"], s["box3d"]
            box2[b], pose2[b] = s["box2d"], s["pose2d"]
        tokens = build_tokens(traj, pose3d=pose3, box3d=box3, box2d=box2,
                              pose2d=pose2, num_3dpose=self.num_3dpose,
                              num_2dpose=self.num_2dpose)
        init_pose, init_vel = extract_locoval_inputs(
            tokens, num_3dpose=min(self.num_3dpose, 24))
        tokens, _ = normalize_scene(tokens)
        padding_mask = np.ones((B, N), bool)
        obs = tokens[:, :OBS_FRAMES]
        gt_future = tokens[:, OBS_FRAMES:, 0, 0, :2]
        return SceneBatch(obs, padding_mask, gt_future, init_pose, init_vel)

    def batches(self, batch_size, num_batches) -> Iterator:
        for _ in range(num_batches):
            yield self.batch(batch_size)


# ---------------------------------------------------------------------------
# trajnet++-style ndjson ingestion (real JTA/JRDB exports)
# ---------------------------------------------------------------------------

def read_ndjson_scenes(path: str, max_scenes: Optional[int] = None):
    """Minimal trajnet++ reader (reference
    utils/trajnetplusplustools/reader.py:10-143): 'scene' rows give
    (id, start, end, primary pedestrian); 'track' rows give
    (frame, pedestrian, x, y). Returns a list of (T, N, 2) arrays with the
    primary agent first."""
    scenes = []
    tracks = {}
    scene_rows = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if "track" in row:
                t = row["track"]
                tracks.setdefault(t["p"], {})[t["f"]] = (t["x"], t["y"])
            elif "scene" in row:
                scene_rows.append(row["scene"])
    for s in scene_rows:
        if max_scenes is not None and len(scenes) >= max_scenes:
            break
        frames = list(range(s["s"], s["e"] + 1))
        primary = s["p"]
        peds = [primary] + [p for p in tracks
                            if p != primary and all(
                                f in tracks[p] for f in frames)]
        arr = np.full((len(frames), len(peds), 2), np.nan, np.float32)
        ok = True
        for j, p in enumerate(peds):
            for i, f in enumerate(frames):
                if f in tracks.get(p, {}):
                    arr[i, j] = tracks[p][f]
                elif j == 0:
                    ok = False
        if ok:
            scenes.append(arr)
    return scenes


_POSE_KEYS_3D = [[f"x{j}", f"y{j}", f"z{j}"] for j in range(NDJSON_POSE_JOINTS)]
_POSE_KEYS_2D = [[f"xx{j}", f"yy{j}"] for j in range(NDJSON_POSE_JOINTS)]
_BOX3_KEYS = ["h", "w", "l", "rot_z"]
_BOX2_KEYS = ["bb_left", "bb_top", "bb_width", "bb_height"]


def read_ndjson_scenes_all_cues(path: str, max_scenes: Optional[int] = None):
    """All-visual-cues trajnet++ reader (reference
    Reader_jta_all_visual_cues, reader.py:144-266, and Reader_jrdb_2dbox,
    :10-143): 'track' rows carry x/y plus, when exported, the 3D box
    (h,w,l,rot_z), 2D box (bb_left/top/width/height), 22 3D pose joints
    (x0..z21) and 22 2D pose joints (xx0..yy21). Rows missing a cue leave
    its slots NaN (the reference's paths_to_xy blank).

    Returns a list of per-scene dicts {traj (T,N,2), box3d (T,N,4),
    box2d (T,N,4), pose3d (T,N,22,3), pose2d (T,N,22,2)} with the primary
    pedestrian at index 0 and NaN where a person/cue is absent.
    """
    tracks = {}
    scene_rows = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if "track" in row:
                t = row["track"]
                rec = tracks.setdefault(t["p"], {})
                rec[t["f"]] = t
            elif "scene" in row:
                scene_rows.append(row["scene"])

    def cue(t, keys):
        return [t.get(k, np.nan) for k in keys]

    scenes = []
    for s in scene_rows:
        if max_scenes is not None and len(scenes) >= max_scenes:
            break
        frames = list(range(s["s"], s["e"] + 1))
        primary = s["p"]
        if any(f not in tracks.get(primary, {}) for f in frames):
            continue
        peds = [primary] + sorted(
            p for p in tracks if p != primary
            and any(f in tracks[p] for f in frames))
        T, N = len(frames), len(peds)
        out = dict(
            traj=np.full((T, N, 2), np.nan, np.float32),
            box3d=np.full((T, N, 4), np.nan, np.float32),
            box2d=np.full((T, N, 4), np.nan, np.float32),
            pose3d=np.full((T, N, NDJSON_POSE_JOINTS, 3), np.nan, np.float32),
            pose2d=np.full((T, N, NDJSON_POSE_JOINTS, 2), np.nan, np.float32),
        )
        for j, p in enumerate(peds):
            rec = tracks[p]
            for i, f in enumerate(frames):
                t = rec.get(f)
                if t is None:
                    continue
                out["traj"][i, j] = (t["x"], t["y"])
                out["box3d"][i, j] = cue(t, _BOX3_KEYS)
                out["box2d"][i, j] = cue(t, _BOX2_KEYS)
                out["pose3d"][i, j] = [cue(t, ks) for ks in _POSE_KEYS_3D]
                out["pose2d"][i, j] = [cue(t, ks) for ks in _POSE_KEYS_2D]
        scenes.append(out)
    return scenes


def write_ndjson_all_cues(path: str, scenes):
    """Inverse of read_ndjson_scenes_all_cues — emit the reference's ndjson
    schema (SceneRow / TrackRow_all_jta field names, trajnetplusplustools/
    data.py:2-7). `scenes` is a list of dicts as produced by
    SyntheticScenes.scene() or the reader; person 0 is the primary. Used by
    the format converter and the committed test fixture."""
    ped_base = 0
    frame_base = 0   # scenes occupy disjoint frame windows, like the
    sid = 0          # reference exports (one video = one growing frame axis)
    r = lambda v: round(float(v), 4)  # noqa: E731
    with open(path, "w") as f:
        for sc in scenes:
            T, N = sc["traj"].shape[:2]
            f.write(json.dumps({"scene": {
                "id": sid, "p": ped_base, "s": frame_base,
                "e": frame_base + T - 1, "fps": FPS}}) + "\n")
            for j in range(N):
                for i in range(T):
                    if np.isnan(sc["traj"][i, j, 0]):
                        continue
                    t = {"f": frame_base + i, "p": ped_base + j,
                         "x": r(sc["traj"][i, j, 0]),
                         "y": r(sc["traj"][i, j, 1])}
                    if "box3d" in sc and not np.isnan(
                            sc["box3d"][i, j]).all():
                        t.update({k: r(v) for k, v in
                                  zip(_BOX3_KEYS, sc["box3d"][i, j])})
                    if "box2d" in sc and not np.isnan(
                            sc["box2d"][i, j]).all():
                        t.update({k: r(v) for k, v in
                                  zip(_BOX2_KEYS, sc["box2d"][i, j])})
                    if "pose3d" in sc and not np.isnan(
                            sc["pose3d"][i, j]).all():
                        for jj, ks in enumerate(_POSE_KEYS_3D):
                            t.update({k: r(v) for k, v in
                                      zip(ks, sc["pose3d"][i, j, jj])})
                    if "pose2d" in sc and not np.isnan(
                            sc["pose2d"][i, j]).all():
                        for jj, ks in enumerate(_POSE_KEYS_2D):
                            t.update({k: r(v) for k, v in
                                      zip(ks, sc["pose2d"][i, j, jj])})
                    f.write(json.dumps({"track": t}) + "\n")
            ped_base += N
            frame_base += T
            sid += 1


class NdjsonScenes:
    """Real-data dataset over trajnet++-style ndjson exports (JTA/JRDB).

    Mirrors the reference pipeline (dataset_jta.py:86-152 preprocessing +
    collate_batch :11-25 pad-to-max-people + drop_ped_with_missing_frame /
    drop_distant_far, utils/data.py:34-100): scenes are windowed to
    OBS+PRED frames, neighbours beyond `max_radius` of the primary agent are
    dropped, people are padded to a fixed count with a padding mask. All
    visual cues present in the export (3D/2D boxes, 3D/2D pose) are parsed
    into their token slots; 2-D-only exports leave those slots zero (the
    model's modality masking treats zeros as absent, like the
    trajectory-only reference configs). The 22 exported pose joints fill the
    first 22 of the model's 24 3D-pose token slots — the reference's live
    path maps JTA pose onto 24 SMPL joints in an external, uncommitted
    preprocessing step (dataset_jta.py loads `preprocess_smpl` pkls that no
    script in the repo produces)."""

    def __init__(self, path: str, max_people: int = 8, max_radius: float = 6.0,
                 seed: int = 0, max_scenes: Optional[int] = None,
                 num_3dpose: int = 24, num_2dpose: int = 22):
        raw = read_ndjson_scenes_all_cues(path, max_scenes=max_scenes)
        self.num_3dpose = num_3dpose
        self.num_2dpose = num_2dpose
        self.windows = []
        for sc in raw:
            arr = sc["traj"]                              # (T, N, 2)
            for s in range(0, len(arr) - TOTAL + 1, TOTAL):
                w = arr[s:s + TOTAL]
                if np.isnan(w[:, 0]).any():
                    continue
                # reference drop rules, applied per window rather than per
                # scene (identical when one scene = one 21-frame track, the
                # reference exports' shape):
                #  * drop_ped_with_missing_frame (utils/data.py:79-91) drops
                #    a neighbour with any NaN x in the first 9 OBSERVED
                #    frames only — NaNs in the prediction horizon survive
                #    and are zeroed after normalization (train_jta.py:108-111)
                #  * drop_distant_far (utils/data.py:93-100) keeps a
                #    neighbour whose nanmin squared distance to the primary
                #    over ALL window frames is < r²
                d2 = np.sum((w - w[:, 0:1]) ** 2, axis=-1)  # (T, N)
                near = np.nanmin(d2, axis=0) < max_radius ** 2
                keep = [0] + [
                    j for j in range(1, w.shape[1])
                    if not np.isnan(w[:OBS_FRAMES, j, 0]).any() and near[j]]
                keep = keep[:max_people]
                sl = slice(s, s + TOTAL)
                self.windows.append({k: v[sl][:, keep]
                                     for k, v in sc.items()})
        if not self.windows:
            raise ValueError(f"no usable scenes in {path}")
        self.max_people = max_people
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.windows)

    def batch(self, batch_size) -> SceneBatch:
        idx = self.rng.randint(0, len(self.windows), batch_size)
        return self.window_batch(idx)

    def window_batch(self, idx) -> SceneBatch:
        """Assemble the given window indices into a SceneBatch —
        deterministic; `batch` samples indices then delegates here."""
        B, N, T = len(idx), self.max_people, TOTAL
        J3, J2 = self.num_3dpose, self.num_2dpose
        traj = np.zeros((B, T, N, 2), np.float32)
        box3 = np.zeros((B, T, N, 4), np.float32)
        box2 = np.zeros((B, T, N, 4), np.float32)
        pose3 = np.zeros((B, T, N, J3, 3), np.float32)
        pose2 = np.zeros((B, T, N, J2, 2), np.float32)
        mask = np.zeros((B, N), bool)
        for b, i in enumerate(idx):
            w = self.windows[i]
            n = w["traj"].shape[1]
            traj[b, :, :n] = w["traj"]
            box3[b, :, :n] = w["box3d"]
            box2[b, :, :n] = w["box2d"]
            pose3[b, :, :n, :min(J3, NDJSON_POSE_JOINTS)] = \
                w["pose3d"][:, :, :J3]
            pose2[b, :, :n, :min(J2, NDJSON_POSE_JOINTS)] = \
                w["pose2d"][:, :, :J2]
            mask[b, :n] = True
        tokens = build_tokens(traj, pose3d=pose3, box3d=box3, box2d=box2,
                              pose2d=pose2, num_3dpose=J3, num_2dpose=J2)
        init_pose, init_vel = extract_locoval_inputs(
            tokens, num_3dpose=min(J3, 24))
        tokens, _ = normalize_scene(tokens)
        # NaNs (neighbour frames missing in the prediction horizon, or a
        # cue absent from the export) survive normalization and are zeroed
        # HERE, like the reference masks them post-normalization
        # (train_jta.py:108-111) — zeroing raw coords pre-normalization
        # would instead inject a spurious −origin delta
        tokens = np.nan_to_num(tokens, nan=0.0)
        init_pose = np.nan_to_num(init_pose, nan=0.0)
        init_vel = np.nan_to_num(init_vel, nan=0.0)
        obs = tokens[:, :OBS_FRAMES]
        gt_future = tokens[:, OBS_FRAMES:, 0, 0, :2]
        return SceneBatch(obs, mask, gt_future, init_pose, init_vel)

    def batches(self, batch_size, num_batches) -> Iterator:
        for _ in range(num_batches):
            yield self.batch(batch_size)
