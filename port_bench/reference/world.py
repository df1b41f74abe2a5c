"""The world the pacer cells step in, rebuilt from the seed, plain PyTorch
and NumPy: the humanoid's bodies from their shape parameters, and the
mixed-terrain heightfield.

The bodies follow the configuration's template shape space (beta[0] the
overall scale, beta[1] the limb length, beta[2] the girth, the rest a
fixed small per-body projection): capsules along the mean child offset,
masses from fixed shares of 77 kg, capsule inertias, PD gains scaled by
the mass. The terrain is `num_tiles`² tiles of `map_length` m, each a
generator drawn by fixed proportions at a drawn difficulty, with a flat
border. Both are frozen copies of the arithmetic that defines the
configuration, so that the same seed gives the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

NAMES = (
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe",
    "R_Hip", "R_Knee", "R_Ankle", "R_Toe",
    "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand")
PARENTS = (-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12,
           11, 14, 15, 16, 17, 11, 19, 20, 21, 22)
NB = len(NAMES)
NJ = NB - 1
MASS_KG = 77.0

OFFSETS = np.array([
    [0.000, 0.000, 0.000], [0.000, 0.084, -0.073], [0.000, 0.000, -0.386],
    [0.000, 0.000, -0.415], [0.130, 0.000, -0.060], [0.000, -0.084, -0.073],
    [0.000, 0.000, -0.386], [0.000, 0.000, -0.415], [0.130, 0.000, -0.060],
    [0.000, 0.000, 0.113], [0.000, 0.000, 0.131], [0.000, 0.000, 0.055],
    [0.000, 0.000, 0.212], [0.000, 0.000, 0.090], [0.000, 0.072, 0.137],
    [0.000, 0.105, 0.000], [0.000, 0.262, 0.000], [0.000, 0.249, 0.000],
    [0.000, 0.085, 0.000], [0.000, -0.072, 0.137], [0.000, -0.105, 0.000],
    [0.000, -0.262, 0.000], [0.000, -0.249, 0.000], [0.000, -0.085, 0.000],
], np.float32)
RADIUS = np.array([
    0.115, 0.070, 0.055, 0.045, 0.035, 0.070, 0.055, 0.045, 0.035,
    0.105, 0.105, 0.110, 0.045, 0.095, 0.055, 0.045, 0.035, 0.030, 0.030,
    0.055, 0.045, 0.035, 0.030, 0.030], np.float32)
MASS_SHARE = np.array([
    0.1366, 0.0700, 0.0465, 0.0130, 0.0020, 0.0700, 0.0465, 0.0130, 0.0020,
    0.0650, 0.0650, 0.1300, 0.0120, 0.0670, 0.0150, 0.0265, 0.0155, 0.0050,
    0.0040, 0.0150, 0.0265, 0.0155, 0.0050, 0.0040], np.float32)
MASS_SHARE = MASS_SHARE / MASS_SHARE.sum()
# (kp, kd, torque limit) of each joint, bodies 1..23
PD = ((500, 50, 500), (500, 50, 500), (400, 40, 500), (200, 20, 500),
      (500, 50, 500), (500, 50, 500), (400, 40, 500), (200, 20, 500),
      (1000, 100, 500), (1000, 100, 500), (1000, 100, 500), (100, 10, 250),
      (100, 10, 250), (400, 40, 500), (400, 40, 500), (300, 30, 150),
      (100, 10, 150), (100, 10, 150), (400, 40, 150), (400, 40, 250),
      (300, 30, 150), (100, 10, 150), (100, 10, 150))
_P = np.pi
LIMITS = (  # symmetric per-axis joint limits, bodies 1..23
    (_P / 2, _P / 2, _P / 2), (_P / 32, _P, _P / 32), (_P / 4, _P / 2, _P / 4),
    (_P / 32, _P / 2, _P / 32), (_P / 2, _P / 3, _P / 3),
    (_P / 32, _P, _P / 32), (_P / 4, _P / 2, _P / 4),
    (_P / 32, _P / 2, _P / 32), (_P / 3, _P / 3, _P / 3),
    (_P / 3, _P / 3, _P / 3), (_P / 3, _P / 3, _P / 3),
    (_P / 2, _P / 2, _P / 2), (_P / 2, _P / 2, _P / 2), (_P, _P, _P),
    (_P, _P, _P), (_P / 2, _P, _P / 32), (_P / 2, _P / 2, _P / 2),
    (_P / 2, _P / 2, _P / 2), (_P, _P, _P), (_P, _P, _P),
    (_P / 2, _P, _P / 32), (_P / 2, _P / 2, _P / 2), (_P / 2, _P / 2, _P / 2))
LEAF = {"L_Toe": (0.10, 0.0, 0.0), "R_Toe": (0.10, 0.0, 0.0),
        "Head": (0.0, 0.0, 0.14), "L_Hand": (0.0, 0.10, 0.0),
        "R_Hand": (0.0, -0.10, 0.0)}


def betas(num_envs: int, seed: int) -> torch.Tensor:
    """Body shapes N(0, 0.3²) (num_envs, 16), drawn on the host from
    `seed`, as the configuration draws them."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((num_envs, 16), generator=gen) * 0.3


def bodies(b: torch.Tensor, device) -> dict:
    """Shape parameters (N, 16) → the bodies' capsules, masses, inertias,
    gains and limits, float32 on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    b = b.to(**f32)
    N = b.shape[0]
    overall = 1.0 + 0.05 * b[:, 0:1]
    limb = 1.0 + 0.04 * b[:, 1:2]
    girth = 1.0 + 0.06 * b[:, 2:3]
    proj = torch.as_tensor(np.random.RandomState(7).randn(13, NB).astype(
        np.float32) * 0.01, **f32)
    per_body = 1.0 + b[:, 3:16] @ proj
    is_limb = torch.as_tensor([n.startswith(("L_", "R_")) for n in NAMES],
                              device=device)
    scale = overall * torch.where(is_limb[None], limb,
                                  torch.ones_like(limb)) * per_body
    offsets = torch.as_tensor(OFFSETS, **f32)[None] * scale[..., None]

    kids = [[c for c in range(1, NB) if PARENTS[c] == k] for k in range(NB)]
    bones = []
    for k in range(NB):
        if kids[k]:
            bones.append(sum(offsets[:, c] for c in kids[k]) / len(kids[k]))
        else:
            bones.append(torch.as_tensor(LEAF[NAMES[k]], **f32).expand(N, 3))
    bones = torch.stack(bones, 1)
    start = torch.zeros_like(offsets)
    for side in ("L_", "R_"):
        ankle, toe = NAMES.index(side + "Ankle"), NAMES.index(side + "Toe")
        t = offsets[:, toe]
        heel = torch.stack([-0.45 * torch.abs(t[:, 0]),
                            torch.zeros_like(t[:, 1]), t[:, 2]], -1)
        start[:, ankle] = heel
        bones[:, ankle] = t - heel
    length = torch.linalg.norm(bones, dim=-1)
    axis = bones / torch.clamp(length[..., None], min=1e-6)
    radius = torch.as_tensor(RADIUS, **f32)[None] * girth * overall
    half = torch.maximum(length * 0.5, radius * 0.5)
    mass = (torch.as_tensor(MASS_SHARE, **f32)[None] * MASS_KG
            * (overall[:, 0] ** 3 * girth[:, 0])[:, None])
    r2, L = radius ** 2, 2 * half
    ax2 = axis ** 2
    inertia = torch.clamp(ax2 * (0.5 * mass * r2)[..., None]
                          + (1 - ax2) * (mass * (L ** 2 / 12.0 + r2 / 4.0)
                                         )[..., None], min=1e-4)
    pd = torch.as_tensor(PD, **f32)
    pd_scale = (mass.sum(-1) / MASS_KG)[:, None]
    return dict(
        offsets=offsets, radius=radius, half=half, axis=axis, start=start,
        com_off=start + axis * half[..., None], mass=mass, inertia=inertia,
        kp=pd[None, :, 0] * pd_scale, kd=pd[None, :, 1] * pd_scale,
        torque_limit=pd[None, :, 2].expand(N, NJ),
        joint_limit=torch.as_tensor(LIMITS, **f32)[None].expand(N, NJ, 3),
        betas=b)


# --- the mixed terrain -------------------------------------------------------

def _uniform_levels(shape, min_h, max_h, rng, step=0.025):
    levels = np.arange(min_h, max_h + step, step)
    return levels[rng.randint(0, len(levels), size=shape)].astype(np.float32)


def _sloped(shape, cell, slope):
    ramp = np.arange(shape[0], dtype=np.float32) * cell * slope
    return np.broadcast_to(ramp[:, None], shape).copy()


def _ring(shape):
    H, W = shape
    x = np.minimum(np.arange(H), H - 1 - np.arange(H))
    y = np.minimum(np.arange(W), W - 1 - np.arange(W))
    return x, y


def _pyramid_sloped(shape, cell, slope):
    x, y = (a.astype(np.float32) for a in _ring(shape))
    return (np.minimum(x[:, None], y[None, :]) * cell * slope).astype(
        np.float32)


def _obstacles(shape, cell, max_h, rng, lo=0.8, hi=1.6, rects=24):
    H, W = shape
    out = np.zeros(shape, np.float32)
    for _ in range(rects):
        w = int(rng.uniform(lo, hi) / cell)
        h = int(rng.uniform(lo, hi) / cell)
        x = rng.randint(0, max(1, H - h))
        y = rng.randint(0, max(1, W - w))
        out[x:x + h, y:y + w] = rng.choice([-max_h, -max_h / 2, max_h / 2,
                                            max_h])
    return out


def _wave(shape, amplitude, waves=2):
    x = np.linspace(0, waves * 2 * np.pi, shape[0])
    y = np.linspace(0, waves * 2 * np.pi, shape[1])
    return (amplitude * (np.sin(x)[:, None] + np.cos(y)[None, :]) / 2
            ).astype(np.float32)


def _stairs(shape, cell, step_height, step_width=0.75):
    sw = max(1, int(step_width / cell))
    steps = (np.arange(shape[0]) // sw).astype(np.float32) * step_height
    return np.broadcast_to(steps[:, None], shape).copy()


def _pyramid_stairs(shape, cell, step_height, step_width=0.75):
    x, y = _ring(shape)
    ring = np.minimum(x[:, None], y[None, :]) // max(1, int(step_width / cell))
    return (ring * step_height).astype(np.float32)


def _stones(shape, cell, height, depth, rng, size_m=0.8, spacing=0.4):
    H, W = shape
    out = np.full(shape, depth, np.float32)
    pitch = max(1, int((size_m + spacing) / cell))
    size = max(1, int(size_m / cell))
    for i in range(0, H, pitch):
        off = rng.randint(0, pitch)
        for j in range(-pitch, W, pitch):
            jj = j + off
            if jj < 0 or jj + size > W:
                continue
            out[i:i + size, jj:jj + size] = rng.uniform(-height, height)
    return out


KINDS = ("random_uniform", "sloped", "pyramid_sloped", "discrete_obstacles",
         "wave", "stairs", "pyramid_stairs", "stepping_stones")
SHARES = (0.2, 0.1, 0.15, 0.15, 0.05, 0.1, 0.15, 0.1)


def heights(seed: int, map_length: float = 8.0, num_tiles: int = 8,
            difficulty: float = 1.0, cell: float = 0.1,
            border: int = 10) -> tuple:
    """(heights (H, W) float32, cell, origin) of the mixed terrain."""
    rng = np.random.RandomState(seed)
    tile = int(map_length / cell)
    n = num_tiles * tile + 2 * border
    big = np.zeros((n, n), np.float32)
    cum = np.cumsum(SHARES) / np.sum(SHARES)
    shape = (tile, tile)
    for i in range(num_tiles):
        for j in range(num_tiles):
            kind = KINDS[int(np.searchsorted(cum, rng.rand()))]
            d = difficulty * rng.uniform(0.4, 1.0)
            if kind == "random_uniform":
                p = _uniform_levels(shape, -0.08 * d, 0.08 * d, rng)
            elif kind == "sloped":
                p = _sloped(shape, cell, 0.35 * d)
            elif kind == "pyramid_sloped":
                p = _pyramid_sloped(shape, cell, 0.35 * d)
            elif kind == "discrete_obstacles":
                p = _obstacles(shape, cell, 0.12 * d, rng)
            elif kind == "wave":
                p = _wave(shape, 0.12 * d)
            elif kind == "stairs":
                p = _stairs(shape, cell, 0.10 * d)
            elif kind == "pyramid_stairs":
                p = _pyramid_stairs(shape, cell, 0.10 * d)
            else:
                p = _stones(shape, cell, 0.05 * d, -0.2 * d, rng)
            big[border + i * tile:border + (i + 1) * tile,
                border + j * tile:border + (j + 1) * tile] = p
    extent = n * cell
    return big, cell, (-extent / 2, -extent / 2)
